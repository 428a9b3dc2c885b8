"""The port's sharded MSM (plonk_tpu_torch.parallel.dist_msm) on a CPU mesh
of 8 shards against the JAX package's dist_msm on its 8-device CPU mesh
(tests/conftest.py), word for word on the affine point (x, y, infinity):

- tests/test_parallel.py's case (64 toy points, default_rng(4), 5-bit
  windows and scalars), the dry run's (default_rng(0)), all-zero scalars,
  and repeated, opposite and infinite points;
- a scaled-curve (MontField) case at 64 SRS points with 31-bit scalars
  against the port's single-device msm_pippenger;
- the refusals (a term count that does not split, a wrong axis, the
  kernel's exchange on a CPU mesh) and the plain exchange's point.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import curve as JC
from plonk_tpu.ops import field as JFM
from plonk_tpu.parallel import dist_msm as JDM
from plonk_tpu.parallel import mesh as JMS
from plonk_tpu.utils import params as JPR
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops.field import Field
from plonk_tpu_torch.ops.msm import msm_pippenger
from plonk_tpu_torch.parallel import mesh as MS
from plonk_tpu_torch.parallel.dist_msm import dist_msm
from plonk_tpu_torch.utils.params import GF101, TOY_CURVE

Fq = Field(GF101)
JFq = JFM.Field(JPR.GF101)
D = 8


def _seeded(seed: int, nbits: int):
    """(multipliers k_i, scalars) of 64 terms as the JAX package's tests
    draw them."""
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 17, size=64, dtype=np.uint32)
    return ks, rng.integers(0, 17, size=64, dtype=np.uint32), nbits


def _edge(_seed: int, nbits: int):
    """Repeated points, opposite pairs (k and 17 - k) and points at
    infinity (k = 0, 17), with repeated and zero scalars."""
    rng = np.random.default_rng(5)
    ks = rng.integers(1, 17, size=64, dtype=np.uint32)
    ks[8:16] = ks[0]
    ks[16:24] = 17 - ks[24:32]
    ks[40:44] = 0
    ks[44:46] = 17
    sc = rng.integers(0, 17, size=64, dtype=np.uint32)
    sc[8:16] = sc[0]
    sc[48:56] = 0
    return ks, sc, nbits


CASES = {
    "test_parallel": lambda: _seeded(4, 32),
    "dryrun": lambda: _seeded(0, 5),
    "zero-scalars": lambda: _seeded(0, 5)[:1] + (
        np.zeros(64, np.uint32), 5),
    "repeated-opposite": lambda: _edge(0, 5),
}


@pytest.fixture(scope="module")
def jax_dist_msm():
    """JAX's dist_msm on its 8-device CPU mesh, 5-bit windows and scalars,
    under one jax.jit for every case (an eager shard_map call takes
    ~100 s of XLA:CPU, the jitted one ~4 s to compile once)."""
    assert jax.device_count() >= D, "conftest must provide 8 cpu devices"
    jmesh = JMS.make_1d_mesh("sp", D)
    return jax.jit(lambda x, y, inf, sc: tuple(JDM.dist_msm(
        JFq, jmesh, JC.G1(x, y, inf), sc, window_bits=5, scalar_bits=5)))


def _jax_case(name, jax_dist_msm):
    """JAX's points (uint32 x, y, bool inf) and its dist_msm point."""
    ks, sc, nbits = CASES[name]()
    g = JC.g1_generator(JPR.TOY_CURVE, JFq)
    pts = JC.g1_mul(JFq, g, jnp.asarray(ks), nbits=nbits)
    got = jax_dist_msm(*pts, jnp.asarray(sc))
    return (tuple(np.asarray(c) for c in pts), sc,
            tuple(np.asarray(c) for c in got))


def _torch_pts(pts) -> C.G1:
    x, y, inf = pts
    return C.G1(torch.as_tensor(x.astype(np.int64)),
                torch.as_tensor(y.astype(np.int64)),
                torch.as_tensor(inf.astype(bool)))


def _words(p: C.G1):
    return (int(p.x), int(p.y), bool(p.inf))


@pytest.mark.parametrize("name", list(CASES))
def test_dist_msm_matches_jax(name, jax_dist_msm):
    pts, sc, want = _jax_case(name, jax_dist_msm)
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    got = dist_msm(Fq, mesh, _torch_pts(pts), sc, window_bits=5,
                   scalar_bits=5)
    assert got.x.shape == () and got.x.device == mesh.device
    assert _words(got) == (int(want[0]), int(want[1]), bool(want[2]))
    # the port's own points are JAX's, and its plain exchange gives the
    # same point
    ks, _, nbits = CASES[name]()
    own = C.g1_mul(Fq, C.g1_generator(TOY_CURVE, Fq, "cpu"),
                   torch.as_tensor(ks.astype(np.int64)), nbits=nbits)
    assert all(np.array_equal(u.numpy(), v.astype(u.numpy().dtype))
               for u, v in zip(own, pts))
    assert _words(dist_msm(Fq, mesh, own, sc, window_bits=5, scalar_bits=5,
                           exchange="plain")) == _words(got)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_dist_msm_scaled_curve_matches_single_device(n_shards):
    """MontField coordinates: 64 points of the scaled curve's SRS with
    31-bit scalars, equal to one msm_pippenger over all of them."""
    ctx = PS.scaled_new(64, device="cpu")
    g = C.G1(*(c[:64] for c in ctx.srs.g1s))
    rng = np.random.default_rng(31)
    sc = torch.as_tensor(rng.integers(0, 1 << 31, size=64))
    sc[:3] = 0
    mesh = MS.make_1d_mesh("sp", n_shards, device="cpu")
    got = dist_msm(ctx.Fq, mesh, g, sc, window_bits=5, scalar_bits=31)
    want = msm_pippenger(ctx.Fq, g, sc, window_bits=5, scalar_bits=31)
    assert _words(got) == _words(want)
    assert not bool(got.inf)


def test_dist_msm_refusals():
    g = C.g1_generator(TOY_CURVE, Fq, "cpu")
    pts = C.g1_mul(Fq, g, torch.arange(1, 13), nbits=5)
    sc = torch.arange(12)
    with pytest.raises(ValueError, match="split"):
        dist_msm(Fq, MS.make_1d_mesh("sp", 8, device="cpu"), pts, sc)
    with pytest.raises(ValueError, match="axis"):
        dist_msm(Fq, MS.make_1d_mesh("dp", 4, device="cpu"), pts, sc)
    # no fallback: the kernel's exchange refuses a CPU mesh
    with pytest.raises(ValueError, match="CUDA"):
        dist_msm(Fq, MS.make_1d_mesh("sp", 4, device="cpu"), pts, sc,
                 exchange="cuda")
