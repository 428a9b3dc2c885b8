"""The mesh-sharded scaled prover of the port (plonk_tpu_torch.parallel.
dist_scan and dist_prover) on CPU meshes.

The whole slice at n = 16 on 4 shards (8 do not split n = 16) equals the
JAX package's proof: its recorded values (tests/test_torch_scaled.py's
anchors) and the port's default-prims proof, which
tests/test_torch_scaled.py holds equal to JAX's word for word. JAX's own
sharded prover is not run here (minutes of shard_map compiles on the CPU);
tests/test_dist_prover.py holds it equal to JAX's single-device proof.
The sharded scan is held against a sequential product and against one
JAX dist_prefix_prod whose totals exchange is the Pallas ring kernel on
the TPU interpret machine. Exact equality."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.parallel import dist_scan as JDS
from plonk_tpu.parallel import mesh as JMS
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.synthetic import square_chain_circuit
from plonk_tpu_torch.ops import commit as CM
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.parallel import collectives as CL
from plonk_tpu_torch.parallel import dist_prover as DP
from plonk_tpu_torch.parallel import dist_scan as DS
from plonk_tpu_torch.parallel import mesh as MS

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)
CH = [1111, 2222, 3333, 4444, 5555]
RND = list(range(1, 10))
# the JAX package's n = 16 proof for (CH, RND), decoded (as in
# tests/test_torch_scaled.py)
ANCHOR_SCALARS = dict(a_z=11535495, b_z=4125738, c_z=8864595,
                      s_sigma_1_z=31108, s_sigma_2_z=85023238,
                      r_z=91913729, z_omega_z=29775783)
ANCHOR_POINTS = dict(a_s=(1379689719, 1885742547),
                     w_z_omega_s=(1642674468, 1818070622))


def _proof_words(ctx, n):
    """(ctx, circuit, the default prims' proof) for square_chain_circuit."""
    circuit = square_chain_circuit(ctx.params.field.p, n)
    proof, diags = PS.make_prover(ctx, *circuit[:2])(*circuit[2:], CH, RND)
    assert bool(diags.all_ok())
    return circuit, proof


@pytest.fixture(scope="module")
def small():
    ctx = PS.scaled_new(16, device="cpu")
    return (ctx,) + _proof_words(ctx, 16)


def _assert_proofs_equal(got, want):
    for name in POINT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert bool(g.inf) == bool(w.inf), name
        assert (int(g.x), int(g.y)) == (int(w.x), int(w.y)), name
    for name in SCALAR_FIELDS:
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def test_dist_prefix_prod_matches_sequential_and_jax():
    mesh = MS.make_1d_mesh("sp", 8, device="cpu")
    rng = np.random.default_rng(7)
    n = 1 << 9
    std = rng.integers(1, F.p, size=n)
    v = F.encode_host(std)
    got = MS.unshard_vector(DS.dist_prefix_prod(
        F, mesh, MS.shard_vector(mesh, torch.as_tensor(v))))
    seq, acc = [], 1
    for f in std:
        acc = acc * int(f) % F.p
        seq.append(acc)
    np.testing.assert_array_equal(F.decode(got).numpy(), seq)
    assert jax.device_count() >= 8, "conftest must provide 8 cpu devices"
    jmesh = JMS.make_1d_mesh("sp", 8)
    want = JDS.dist_prefix_prod(J, jmesh, jnp.asarray(v.astype(np.uint32)),
                                "sp", exchange="pallas_sim")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("D,n", [(1, 1 << 6), (2, 1 << 6), (8, 1 << 6),
                                 (8, 1 << 15)])
def test_dist_grand_product_matches_sequential(D, n):
    """Shards of 4096 elements and more take the chunked local scan."""
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    rng = np.random.default_rng(8 + D)
    std = rng.integers(1, F.p, size=n - 1)
    fractions = torch.as_tensor(F.encode_host(np.concatenate([std, [1]])))
    acc = MS.unshard_vector(DS.dist_grand_product(
        F, mesh, MS.shard_vector(mesh, fractions)))
    want = [1]
    for f in std:
        want.append(want[-1] * int(f) % F.p)
    np.testing.assert_array_equal(F.decode(acc).numpy(), want)


@pytest.mark.parametrize("D", [3, 8])
def test_dist_commit_matches_local(small, D):
    """The table split over D shards (L = 22 padded to a multiple of D
    with infinity entries) commits the single-device points."""
    ctx = small[0]
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    rng = np.random.default_rng(D)
    coeffs = [torch.as_tensor(F.encode_host(rng.integers(0, F.p,
                                                         size=16 + k)))
              for k in (1, 4, 6)]
    local = PS._commit_many(ctx, coeffs)
    dist = DP.dist_commit_many(ctx, mesh, coeffs)
    for a, b in zip(local, dist):
        assert torch.equal(a, b)
    tables = DP._pad_table(ctx, mesh)
    assert len(tables) == D and all(t.x.is_contiguous() for t in tables)
    Ls = tables[0].x.shape[2]
    assert Ls * D == -(-ctx.srs.length // D) * D
    pad = torch.cat([t.inf for t in tables], dim=-1)[..., ctx.srs.length:]
    assert bool(pad.all())


def test_sharded_proof_n16_matches_jax(small):
    """The whole slice: prove_scaled with make_dist_prims on 4 CPU shards
    gives JAX's n = 16 proof word for word, with each exchange."""
    ctx, circuit, ref = small
    mesh = MS.make_1d_mesh("sp", 4, device="cpu")
    for exchange in (None, "plain"):
        proof, diags = PS.prove_scaled(
            ctx, *circuit, CH, RND,
            prims=DP.make_dist_prims(ctx, mesh, exchange=exchange))
        assert bool(diags.all_ok())
        _assert_proofs_equal(proof, ref)
        for name, want in ANCHOR_SCALARS.items():
            assert int(getattr(proof, name)) == want, name
        for name, (x, y) in ANCHOR_POINTS.items():
            pt = getattr(proof, name)
            assert not bool(pt.inf)
            assert (int(ctx.Fq.decode(pt.x)), int(ctx.Fq.decode(pt.y))) == (
                x, y), name


def test_sharded_proof_launch_sites(small, monkeypatch):
    """One prove_scaled with the sharded prims (precompute inside) makes 15
    all-to-alls (3 per interpolation x 3, 2 per coset transform x 3), one
    all-gather and one commit per shard: the launches of K9, K8 and K2 on
    a CUDA mesh. Counted on the CPU with the wrappers wrapped (an
    all_to_all on CPU shards is one all_to_all_plain)."""
    ctx, circuit, _ = small
    calls = {"all_to_all": 0, "all_gather": 0, "commit_many": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(CL, "all_to_all_plain",
                        counted("all_to_all", CL.all_to_all_plain))
    monkeypatch.setattr(CL, "all_gather_into",
                        counted("all_gather", CL.all_gather_into))
    monkeypatch.setattr(DP, "commit_many",
                        counted("commit_many", CM.commit_many))
    mesh = MS.make_1d_mesh("sp", 4, device="cpu")
    _, diags = PS.prove_scaled(ctx, *circuit, CH, RND,
                               prims=DP.make_dist_prims(ctx, mesh))
    assert bool(diags.all_ok())
    assert calls == {"all_to_all": 15, "all_gather": 1, "commit_many": 4}


def test_sharded_proof_8_shards_n1024_matches_default():
    ctx = PS.scaled_new(1 << 10, secret=13572468, device="cpu")
    circuit, ref = _proof_words(ctx, 1 << 10)
    mesh = MS.make_1d_mesh("sp", 8, device="cpu")
    proof, diags = PS.prove_scaled(ctx, *circuit, CH, RND,
                                   prims=DP.make_dist_prims(ctx, mesh))
    assert bool(diags.all_ok())
    _assert_proofs_equal(proof, ref)


def test_sharded_prims_refusals(small):
    ctx, circuit, _ = small
    # n = 16 does not split over 8 shards (JAX's _split raises the same)
    prims = DP.make_dist_prims(ctx, MS.make_1d_mesh("sp", 8, device="cpu"))
    with pytest.raises(ValueError, match="cannot split"):
        PS.prove_scaled(ctx, *circuit, CH, RND, prims=prims)
    # the mesh must be where the context is
    with pytest.raises(ValueError, match="the context on cpu"):
        DP.make_dist_prims(ctx, MS.Mesh("sp", (torch.device("cuda", 0),)))
    # the kernels need a CUDA mesh
    prims = DP.make_dist_prims(ctx, MS.make_1d_mesh("sp", 4, device="cpu"),
                               exchange="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        PS.prove_scaled(ctx, *circuit, CH, RND, prims=prims)
