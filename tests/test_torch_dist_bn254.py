"""The port's mesh-sharded BN254 prover (plonk_tpu_torch.parallel.
dist_bn254) on CPU meshes. Exact equality everywhere.

- dist_big_prefix_prod on 8 shards equals the Python-int fold (the check
  of tests/test_parallel.py) and JAX's dist_big_prefix_prod on its
  8-device CPU mesh;
- dist_big_commit_many on the window table's route and on the Pippenger
  route equals the single-device commit, with SRS lengths that do not
  divide by the shard count;
- the n = 8 proof of make_prover_bn254 under make_dist_bn254_prims on a
  2-shard CPU mesh: diagnostics ok; word for word JAX's sharded proof on
  its 2-device mesh and JAX's single-device proof
  (tests/test_torch_bn254.py's values), on the table route (pinned by
  tests/torch_bn254_env.py) and under PLONK_TPU_BN254_FB=0; accepted by
  verify_bn254, rejected with r_z tampered;
- make_dist_bn254_prims refuses a proof batch and a mesh on another
  device.

JAX's sharded values take minutes of XLA:CPU, so they were recorded once
in tests/golden/dist_bn254_jax.json;

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_dist_bn254.py -k recompute

recomputes and compares them (~10 minutes).
"""
import os

import numpy as np
import pytest
import torch

from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models.synthetic import (bn254_mul_circuit, from_words,
                                              words_vec)
from plonk_tpu_torch.parallel import dist_bn254 as DB
from plonk_tpu_torch.parallel import mesh as MS
from test_torch_bn254 import JAX_POINTS, JAX_SCALARS
from test_torch_dist_bigntt import GOLDEN, F, golden_inputs, _ints
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

N_PROOF = 8
SECRET = 987654321
CH = words_vec([111111, 222222, 333333, 444444, 555555])
RND = words_vec(range(17, 26))


@pytest.fixture(scope="module")
def ctx():
    return PB.bn254_setup(N_PROOF, secret=SECRET, device="cpu")


@pytest.fixture(scope="module")
def circuit():
    return bn254_mul_circuit(N_PROOF)


@pytest.fixture(scope="module")
def mesh2():
    return MS.make_1d_mesh("sp", 2, device="cpu")


@pytest.fixture(scope="module")
def sharded(ctx, circuit, mesh2):
    """(prover, proof, diagnostics) of the table route on 2 shards."""
    sel, cp, a, b, c = circuit
    prover = PB.make_prover_bn254(ctx, sel, cp,
                                  prims=DB.make_dist_bn254_prims(ctx, mesh2))
    return (prover,) + prover(a, b, c, CH, RND)


def _point(p):
    return None if bool(p.inf) else (from_words(p.x), from_words(p.y))


def _assert_recorded(proof):
    """The proof equals JAX's sharded proof and JAX's single-device one."""
    jax_dist = GOLDEN["proof_n8_d2"]
    for name in PB.SCALAR_FIELDS:
        got = from_words(getattr(proof, name))
        assert got == JAX_SCALARS[name] == int(jax_dist[name], 16), name
    for name in PB.POINT_FIELDS:
        got = _point(getattr(proof, name))
        assert got == JAX_POINTS[name] == tuple(
            int(v, 16) for v in jax_dist[name]), name


def test_prefix_prod_matches_fold_and_jax():
    mesh = MS.make_1d_mesh("sp", 8, device="cpu")
    x = golden_inputs()
    got = MS.unshard_rows(DB.dist_big_prefix_prod(
        F, mesh, MS.shard_rows(mesh, torch.as_tensor(x))))
    acc, want = 1, []
    for v in F.decode_host(x):
        acc = acc * int(v) % F.p
        want.append(acc)
    assert [int(v) for v in F.decode_host(got.numpy())] == want
    assert _ints(got) == GOLDEN["dist_big_prefix_prod_n64_d8"]


def _coeffs(ctx, lengths, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(ctx.Fr.encode_host(np.asarray(
        [int.from_bytes(rng.bytes(32), "little") % ctx.Fr.p
         for _ in range(n)], dtype=object))) for n in lengths]


def _assert_commits_equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_commit_table_route_matches_single_device(ctx, D):
    """L = 13 points pad to 14 and 16: the padding's scalars are zero and
    its entries never selected."""
    coeffs = _coeffs(ctx, (13, 5), D)
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    _assert_commits_equal(DB.dist_big_commit_many(ctx, mesh, coeffs),
                          PB.bn254_table_commit(ctx)(coeffs))


def test_commit_pippenger_route_matches_single_device(ctx, monkeypatch):
    """Without the table: one Pippenger pass whose 8 lanes are the shards'
    2-point slices (L = 13 padded to 16)."""
    coeffs = _coeffs(ctx, (13,), 9)
    want = PB.bn254_table_commit(ctx)(coeffs)
    monkeypatch.setenv("PLONK_TPU_BN254_FB", "0")
    mesh = MS.make_1d_mesh("sp", 8, device="cpu")
    _assert_commits_equal(DB.dist_big_commit_many(ctx, mesh, coeffs), want)


def test_sharded_proof_diagnostics(sharded):
    assert bool(sharded[2].all_ok())


def test_sharded_proof_matches_recorded_jax(sharded):
    _assert_recorded(sharded[1])


def test_sharded_proof_verifies(ctx, circuit, mesh2, sharded):
    """The pairing verifier accepts the sharded proof (its verifying key
    committed through the sharded prims) and rejects it with r_z tampered:
    verify_bn254 of each, as the two lanes of one verify_bn254_many (lane
    i is verify_bn254 of proof i; one batched call takes ~60 % of two)."""
    sel, cp = circuit[:2]
    proof = sharded[1]
    vk = PB.make_vk_bn254(ctx, sel, cp,
                          prims=DB.make_dist_bn254_prims(ctx, mesh2))
    bad = proof._replace(r_z=torch.as_tensor(words_vec(
        [(from_words(proof.r_z) + 1) % ctx.Fr.p])[0].astype(np.int64)))
    ok = PB.verify_bn254_many(ctx, vk, PB.stack_proofs([proof, bad]),
                              np.stack([CH, CH]))
    assert ok.tolist() == [True, False]


def test_sharded_proof_without_table(ctx, circuit, mesh2, monkeypatch):
    """PLONK_TPU_BN254_FB=0: the commitments of one Pippenger pass over
    the shards' slices give the same proof."""
    monkeypatch.setenv("PLONK_TPU_BN254_FB", "0")
    sel, cp, a, b, c = circuit
    proof, diags = PB.prove_bn254(ctx, sel, cp, a, b, c, CH, RND,
                                  prims=DB.make_dist_bn254_prims(ctx, mesh2))
    assert bool(diags.all_ok())
    _assert_recorded(proof)


def test_refuses_a_proof_batch(ctx, circuit, mesh2, sharded):
    sel, cp, a, b, c = circuit
    two = lambda x: np.stack([x, x])
    with pytest.raises(ValueError, match="item 10"):
        sharded[0](two(a), two(b), two(c), two(CH), two(RND))
    prims = DB.make_dist_bn254_prims(ctx, mesh2)
    Fr = ctx.Fr
    for call in (lambda: prims.intt_n(Fr, Fr.zeros((2, 4, 8), "cpu")),
                 lambda: prims.ntt4n(Fr, Fr.zeros((2, 6, 32), "cpu")),
                 lambda: prims.grand_product(Fr, Fr.zeros((2, 7), "cpu")),
                 lambda: prims.commit_many([Fr.zeros((2, 13), "cpu")])):
        with pytest.raises(ValueError, match="item 10"):
            call()


def test_refuses_a_mesh_on_another_device(ctx):
    with pytest.raises(ValueError, match="the mesh is on"):
        DB.make_dist_bn254_prims(ctx, MS.Mesh("sp", ("meta", "meta")))


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="JAX's sharded prover on a 2-device CPU mesh "
                           "(~10 minutes of XLA:CPU); set "
                           "PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values(circuit):
    import json
    import jax.numpy as jnp
    from plonk_tpu.models import plonk_bn254 as JPB
    from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
    from plonk_tpu.parallel import dist_bn254 as JDB
    from plonk_tpu.parallel.mesh import make_1d_mesh
    from plonk_tpu.utils.params import BN254_FR
    pp = np.asarray(JDB.dist_big_prefix_prod(
        JBigMontField(BN254_FR), make_1d_mesh("sp", 8),
        jnp.asarray(golden_inputs().astype(np.uint32))))
    got = {"dist_big_prefix_prod_n64_d8": [hex(from_words(r)) for r in pp]}
    sel, cp, a, b, c = circuit
    jctx = JPB.bn254_setup(N_PROOF, secret=SECRET, rolled=True)
    proof, diags = JPB.prove_bn254(
        jctx, sel, cp, a, b, c, CH, RND,
        prims=JDB.make_dist_bn254_prims(jctx, make_1d_mesh("sp", 2)))
    assert bool(np.asarray(diags.all_ok()))
    rec = {}
    for name in PB.SCALAR_FIELDS:
        rec[name] = hex(from_words(np.asarray(getattr(proof, name))))
    for name in PB.POINT_FIELDS:
        p = getattr(proof, name)
        rec[name] = None if bool(np.asarray(p.inf)) else [
            hex(from_words(np.asarray(p.x))), hex(from_words(np.asarray(p.y)))]
    got["proof_n8_d2"] = rec
    print(json.dumps(got))
    assert got["dist_big_prefix_prod_n64_d8"] == GOLDEN[
        "dist_big_prefix_prod_n64_d8"]
    assert rec == GOLDEN["proof_n8_d2"]
