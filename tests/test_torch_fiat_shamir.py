"""The port's BLAKE2b Fiat–Shamir provers (plonk_tpu_torch.models.
fiat_shamir) against the JAX package's, on the CPU.

- transcript bytes (`_array_bytes`, `point_bytes`) and the verifier's
  replay (`_derive_from_proof`) equal JAX's on the same inputs;
- the scaled FS proof at n = 8 (the fixture of tests/test_fiat_shamir.py:
  secret 555666777, square_chain_circuit(r, 8, x0=5), rand9 11..99) and
  the toy `prove_fs` proof (canonical circuit, fixed SRS, the blinding of
  tests/test_fiat_shamir.py's toy test) equal JAX's word for word, nonce
  and challenge included; they verify, tampering is rejected, the public
  inputs are bound, and a refused beta/gamma takes the next nonce.

JAX's FS provers take minutes on the CPU (the scaled one ~4 minutes of
XLA compile), so their proofs were recorded once; they are what

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_fiat_shamir.py -k recompute

recomputes and compares."""
import os

import numpy as np
import pytest
import torch

from plonk_tpu.models import fiat_shamir as JFS
from plonk_tpu.utils.params import scaled_plonk_params as j_scaled_params
from plonk_tpu_torch.models import fiat_shamir as FS
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.presets import (canonical_assignments,
                                            canonical_constraints,
                                            canonical_context)
from plonk_tpu_torch.models.synthetic import square_chain_circuit
from plonk_tpu_torch.ops.curve import G1
from plonk_tpu_torch.utils import convert

torch.set_num_threads(1)   # thousands of small ops: see test_torch_bn254

N = 8
SECRET = 555666777
RND = [11, 22, 33, 44, 55, 66, 77, 88, 99]
LABEL = b"tpu-plonk-fs-v2"
# JAX's ScaledFsProver proof for that fixture: points as their (x, y) words
# and inf, evaluations in standard form
JAX_FS = dict(
    nonce=0, challenge=[93567201, 14502462, 107784349, 78814206, 67975777],
    a_s=(388154980, 579396566, False), b_s=(1160696682, 1481377300, False),
    c_s=(139345396, 198003734, False), z_s=(1914982248, 165728611, False),
    t_lo_s=(1737050852, 1945442992, False),
    t_mid_s=(1800864372, 1297033429, False),
    t_hi_s=(356640434, 1114767197, False),
    w_z_s=(1221423774, 1802934828, False),
    w_z_omega_s=(209711139, 339054341, False),
    a_z=17478657, b_z=113235651, c_z=77688774, s_sigma_1_z=98714606,
    s_sigma_2_z=105806995, r_z=72664519, z_omega_z=53710347)
TOY_RND = [7, 4, 11, 12, 16, 2, 14, 11, 7]
# JAX's prove_fs proof of the canonical circuit
JAX_TOY_FS = dict(
    nonce=0, challenge=[5, 15, 8, 9, 10],
    a_s=(91, 66, False), b_s=(26, 45, False), c_s=(91, 35, False),
    z_s=(26, 45, False), t_lo_s=(12, 32, False), t_mid_s=(18, 52, False),
    t_hi_s=(18, 52, False), w_z_s=(18, 52, False),
    w_z_omega_s=(26, 45, False),
    a_z=0, b_z=2, c_z=13, s_sigma_1_z=4, s_sigma_2_z=1, r_z=15,
    z_omega_z=3)


def fs_fields(out) -> dict:
    """An FS proof (either package's) as JAX_FS's dict."""
    d = dict(nonce=int(out.nonce),
             challenge=[int(v) for v in np.asarray(out.challenge)])
    for name in POINT_FIELDS:
        pt = getattr(out.proof, name)
        d[name] = (int(pt.x), int(pt.y), bool(pt.inf))
    for name in SCALAR_FIELDS:
        d[name] = int(getattr(out.proof, name))
    return d


def np_points(pts) -> list:
    return [G1(*(t.numpy() for t in pt)) for pt in pts]


@pytest.fixture(scope="module")
def fs():
    ctx = PS.scaled_new(N, secret=SECRET, device="cpu")
    circuit = square_chain_circuit(ctx.params.field.p, N, x0=5)
    prover = FS.ScaledFsProver(ctx, *circuit[:2])
    out, diags = prover.prove(*circuit[2:], RND)
    return ctx, prover, circuit, out, diags


@pytest.mark.parametrize("arr", [
    np.uint32(7), np.array([1, 2, 3], np.uint32),
    np.arange(6, dtype=np.int64).reshape(2, 3), np.array(True),
    np.array([True, False]), np.array([1], np.uint32)],
    ids=["0d", "vector", "matrix", "bool0d", "bools", "one"])
def test_array_bytes_match_jax(arr):
    assert FS._array_bytes(torch.as_tensor(np.asarray(arr).astype(
        np.int64 if arr.dtype != bool else bool))) == JFS._array_bytes(arr)
    assert FS._array_bytes(arr) == JFS._array_bytes(arr)


def test_point_bytes_match_jax():
    """A 0-d point and a batch hash their full arrays (with the shape
    header), as JAX's: a (1,) point differs from a 0-d one."""
    pts = [G1(torch.tensor(5), torch.tensor(9), torch.tensor(False)),
           G1(torch.tensor([5, 6]), torch.tensor([9, 10]),
              torch.tensor([False, True])),
           G1(torch.tensor([5]), torch.tensor([9]), torch.tensor([False]))]
    got = [FS.point_bytes(p) for p in pts]
    assert got == [JFS.point_bytes(p) for p in np_points(pts)]
    assert len(set(got)) == 3


def test_fs_proof_matches_recorded_jax(fs):
    ctx, _, _, out, diags = fs
    assert bool(diags.all_ok())
    assert fs_fields(out) == JAX_FS
    alpha, beta, gamma, z, v = (int(x) for x in out.challenge)
    assert 0 not in (alpha, beta, gamma, z, v)
    assert pow(z, N, ctx.params.field.p) != 1


def test_derive_from_proof_matches_jax(fs):
    """The verifier's replay of both packages on the same proof and
    verifying key (JAX's on numpy copies), without and with public
    inputs, and the proof's challenge; the FS proof crosses to numpy and
    back whole."""
    ctx, prover, _, out, _ = fs
    vk_np = np_points(prover.vk)
    proof_np = convert.proof_to_numpy(out.proof)
    for pi in (None, np.arange(N, dtype=np.uint32)):
        got = FS._derive_from_proof(LABEL, ctx.params, N, list(prover.vk),
                                    out.proof, out.nonce, pi)
        want = JFS._derive_from_proof(LABEL, j_scaled_params(N), N, vk_np,
                                      proof_np, out.nonce, pi)
        np.testing.assert_array_equal(got, want)
        assert (pi is None) == (got.tolist() == JAX_FS["challenge"])
    back = convert.fs_proof_from_numpy(convert.fs_proof_to_numpy(out), "cpu")
    assert type(back) is FS.FsProof and fs_fields(back) == JAX_FS
    jax_typed = JFS.FsProof(proof_np, out.nonce, out.challenge)
    assert fs_fields(convert.fs_proof_from_numpy(jax_typed, "cpu")) == JAX_FS


def test_fs_proof_equals_interactive_prover(fs):
    """prove_scaled given the derived challenges gives the same proof."""
    ctx, _, circuit, out, _ = fs
    proof, diags = PS.prove_scaled(ctx, *circuit, out.challenge, RND)
    assert bool(diags.all_ok())
    assert fs_fields(FS.FsProof(proof, out.nonce, out.challenge)) == \
        fs_fields(out)


def test_fs_verify_accepts(fs):
    ctx, prover, _, out, _ = fs
    assert FS.verify_scaled_fs(ctx, prover.vk, out)


@pytest.mark.parametrize("tamper", ["evaluation", "commitment", "nonce"])
def test_fs_verify_rejects_tampered(fs, tamper):
    ctx, prover, _, out, _ = fs
    p, nonce = out.proof, out.nonce
    if tamper == "evaluation":
        p = p._replace(a_z=(p.a_z + 1) % ctx.params.field.p)
    elif tamper == "commitment":
        p = p._replace(z_s=p.z_s._replace(x=p.z_s.x + 1))
    else:
        nonce += 1
    assert not FS.verify_scaled_fs(ctx, prover.vk,
                                   FS.FsProof(p, nonce, out.challenge))


def test_fs_public_inputs_bound(fs):
    """Gate 0 rebound to a[0] + PI[0] = 0: the proof for PI verifies under
    PI, and not under PI with one input changed (the transcript absorbs
    the public inputs, so every challenge moves)."""
    ctx, _, circuit, _, _ = fs
    sel, cp, a, b, c = (np.array(x) for x in circuit)
    r = ctx.params.field.p
    sel[:, 0] = 0
    sel[0, 0] = 1
    pi = np.zeros(N, dtype=np.uint32)
    pi[0] = (r - int(a[0])) % r
    prover = FS.ScaledFsProver(ctx, sel, cp)
    out, diags = prover.prove(a, b, c, RND, public_inputs=pi)
    assert bool(diags.all_ok())
    assert FS.verify_scaled_fs(ctx, prover.vk, out, public_inputs=pi)
    pi2 = pi.copy()
    pi2[0] = (int(pi2[0]) + 1) % r
    ch2 = FS._derive_from_proof(LABEL, ctx.params, N, list(prover.vk),
                                out.proof, out.nonce, pi2)
    assert (ch2 != out.challenge).all()
    assert not FS.verify_scaled_fs(ctx, prover.vk, out, public_inputs=pi2)


def test_fs_retry_takes_the_next_nonce(fs, monkeypatch):
    """A vanishing denominator at nonce 0 (forced) makes the prover retry
    with nonce 1, whose challenges the verifier's replay derives; with
    every nonce refused it raises after max_retries attempts."""
    ctx, prover, circuit, _, _ = fs
    real = PS._stage_grand_product
    calls = []

    def refuse(limit):
        def stage(*args):
            z_x, ok = real(*args)
            calls.append(1)
            return z_x, ok & torch.tensor(len(calls) > limit)
        return stage

    monkeypatch.setattr(PS, "_stage_grand_product", refuse(1))
    out, diags = prover.prove(*circuit[2:], RND)
    assert out.nonce == 1 and bool(diags.all_ok()) and len(calls) == 2
    ch = FS._derive_from_proof(LABEL, ctx.params, N, list(prover.vk),
                               out.proof, 1)
    np.testing.assert_array_equal(ch, out.challenge)
    assert ch.tolist() != JAX_FS["challenge"]
    calls.clear()
    monkeypatch.setattr(PS, "_stage_grand_product", refuse(10 ** 6))
    with pytest.raises(RuntimeError, match="in 5 retries"):
        prover.prove(*circuit[2:], RND, max_retries=5)
    assert len(calls) == 5


@pytest.fixture(scope="module")
def toy():
    ctx = canonical_context(srs_mode="fixed", device="cpu")
    out, diags = FS.prove_fs(ctx, canonical_constraints(),
                             canonical_assignments(), TOY_RND)
    return ctx, out, diags


def test_toy_prove_fs_matches_recorded_jax(toy):
    ctx, out, diags = toy
    assert bool(diags.all_ok())
    assert fs_fields(out) == JAX_TOY_FS


def test_toy_verify_fs_accepts_and_rejects_tampered(toy):
    ctx, out, _ = toy
    cons = canonical_constraints()
    assert FS.verify_fs(ctx, cons, out)
    bad = out.proof._replace(a_z=(out.proof.a_z + 1) % 17)
    assert not FS.verify_fs(ctx, cons, FS.FsProof(bad, out.nonce,
                                                  out.challenge))


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="JAX's FS provers take minutes of XLA:CPU; set "
                           "PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values(fs, toy):
    """JAX's scaled and toy FS proofs, carried across with their nonce and
    challenge, equal the recorded values and the port's proofs."""
    from plonk_tpu.models import plonk_scaled as JPS
    from plonk_tpu.models import presets as JPR
    from plonk_tpu.models.synthetic import square_chain_circuit as j_chain
    jctx = JPS.scaled_new(N, secret=SECRET)
    sel, cp, a, b, c = j_chain(jctx.params.field.p, N, x0=5)
    jout, jdiags = JFS.ScaledFsProver(jctx, sel, cp).prove(
        a, b, c, np.array(RND, np.uint32))
    assert bool(jdiags.all_ok())
    got = fs_fields(convert.fs_proof_from_numpy(jout, "cpu"))
    print(got)
    assert got == JAX_FS == fs_fields(fs[3])
    jout, jdiags = JFS.prove_fs(
        JPR.canonical_context(srs_mode="fixed"), JPR.canonical_constraints(),
        JPR.canonical_assignments(), np.array(TOY_RND, np.uint32))
    assert bool(jdiags.all_ok())
    got = fs_fields(jout)
    print(got)
    assert got == JAX_TOY_FS == fs_fields(toy[1])
