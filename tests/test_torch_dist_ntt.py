"""Parity of the port's sharded four-step NTT (plonk_tpu_torch.parallel.
dist_ntt) with the JAX package over SCALED_FR at 2^9 points on an
8-shard CPU mesh: against JAX's local transforms permuted by
`transposed_perm`, as tests/test_parallel.py checks JAX's own, and
against one JAX `dist_ntt` call whose transposes are the Pallas all-to-all
on the TPU interpret machine (`exchange="pallas_sim"`). Exact equality."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.parallel import dist_ntt as JDN
from plonk_tpu.parallel import mesh as JMS
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.parallel import dist_ntt as DN
from plonk_tpu_torch.parallel import mesh as MS

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)
N_TEST = 1 << 9
W = SCALED_FR.root_of_unity(N_TEST)


@pytest.fixture(scope="module")
def mesh8():
    return MS.make_1d_mesh("sp", 8, device="cpu")


def _mont(rng, shape) -> np.ndarray:
    """Montgomery words of random field elements."""
    return F.encode_host(rng.integers(0, F.p, size=shape))


def _sharded(mesh, x: np.ndarray):
    return MS.shard_vector(mesh, torch.as_tensor(x))


def test_twiddles_split_and_perm_match_jax():
    for inverse in (False, True):
        np.testing.assert_array_equal(
            DN._twiddle_all(F.p, W, 32, 16, 8, inverse),
            JDN._twiddle_all(J.p, W, 32, 16, 8, inverse))
    for n, D in ((N_TEST, 8), (16, 4), (1 << 18, 8), (1 << 16, 8)):
        assert DN._split(n, D) == JDN._split(n, D)
        np.testing.assert_array_equal(DN.transposed_perm(n, D),
                                      JDN.transposed_perm(n, D))
    # n = 16 does not split over 8 shards, in either package
    for split in (DN._split, JDN._split):
        with pytest.raises(ValueError, match="cannot split"):
            split(16, 8)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_dist_transforms_match_jax_local(mesh8, batch):
    """dist_ntt == JAX's ntt in the transposed layout; dist_intt inverts
    it; dist_interpolate == JAX's intt; dist_ntt_mul == the cyclic
    product through JAX's local transforms."""
    rng = np.random.default_rng(len(batch))
    x = _mont(rng, batch + (N_TEST,))
    jx = jnp.asarray(x.astype(np.uint32))
    perm = DN.transposed_perm(N_TEST, 8)
    j_ntt = jax.jit(lambda v: JN.ntt(J, v, W))
    j_intt = jax.jit(lambda v: JN.intt(J, v, W))
    fwd = MS.unshard_vector(DN.dist_ntt(F, mesh8, _sharded(mesh8, x), W))
    np.testing.assert_array_equal(
        fwd.numpy(), np.asarray(j_ntt(jx), np.int64)[..., perm])
    back = DN.dist_intt(F, mesh8, MS.shard_vector(mesh8, fwd), W)
    np.testing.assert_array_equal(MS.unshard_vector(back).numpy(), x)
    interp = DN.dist_interpolate(F, mesh8, _sharded(mesh8, x), W)
    np.testing.assert_array_equal(MS.unshard_vector(interp).numpy(),
                                  np.asarray(j_intt(jx), np.int64))
    y = _mont(rng, batch + (N_TEST,))
    prod = DN.dist_ntt_mul(F, mesh8, _sharded(mesh8, x), _sharded(mesh8, y),
                           W)
    jy = jnp.asarray(y.astype(np.uint32))
    want = j_intt(J.mul(j_ntt(jx), j_ntt(jy)))
    np.testing.assert_array_equal(MS.unshard_vector(prod).numpy(),
                                  np.asarray(want, np.int64))


def test_dist_ntt_matches_jax_pallas_exchange(mesh8):
    """One batched JAX dist_ntt whose transposes are K9's TPU kernel on
    the interpret machine: the port's words, with both exchanges."""
    assert jax.device_count() >= 8, "conftest must provide 8 cpu devices"
    jmesh = JMS.make_1d_mesh("sp", 8)
    rng = np.random.default_rng(9)
    x = _mont(rng, (2, N_TEST))
    want = np.asarray(JDN.dist_ntt(J, jmesh, jnp.asarray(x.astype(np.uint32)),
                                   W, exchange="pallas_sim"), np.int64)
    for exchange in (None, "plain"):
        got = DN.dist_ntt(F, mesh8, _sharded(mesh8, x), W, exchange=exchange)
        np.testing.assert_array_equal(MS.unshard_vector(got).numpy(), want)


def test_dist_ntt_inverse_flag_and_shapes(mesh8):
    """inverse=True is the transform with w^-1 (unscaled), and a sharded
    value of the wrong number of shards or length is refused."""
    rng = np.random.default_rng(4)
    x = _mont(rng, (N_TEST,))
    inv = DN.dist_ntt(F, mesh8, _sharded(mesh8, x), W, inverse=True)
    fwd = DN.dist_ntt(F, mesh8, _sharded(mesh8, x), pow(W, -1, F.p))
    assert torch.equal(MS.unshard_vector(inv), MS.unshard_vector(fwd))
    with pytest.raises(ValueError, match="shards for a mesh of 8"):
        DN.dist_ntt(F, mesh8, _sharded(mesh8, x)[:4], W)
    with pytest.raises(ValueError, match="cannot split"):
        DN.dist_ntt(F, mesh8, _sharded(mesh8, x[:16]), SCALED_FR.
                    root_of_unity(16))
