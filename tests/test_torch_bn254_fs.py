"""The port's non-interactive BN254 provers and batched BN254 verifier
(plonk_tpu_torch.models.fiat_shamir.BN254FsProver,
fs_poseidon.BN254PoseidonFsProver, plonk_bn254.verify_bn254_many) against
the JAX package's, on the CPU at n = 8 gates.

The circuit, secret and blinding are those of tests/test_torch_bn254.py
(bn254_mul_circuit(8), secret 987654321, rand9 = 17..25; prove_many's
second lane rand9 = 31..39). Held word for word (tolerance zero) against
values recorded once from JAX (tests/golden/bn254_fs_jax.json, which
chip_smoke.py reads too), because JAX's BN254 provers take ~15 minutes and
more of XLA:CPU compile:

- the BLAKE2b and the Poseidon FS proofs: every point and evaluation, the
  nonce and the challenge;
- JAX's Poseidon prove_many lanes at B = 2;
- JAX's verify_bn254_many flags on [the interactive proof of
  tests/test_torch_bn254.py, the BLAKE2b FS proof, the Poseidon FS proof,
  the BLAKE2b FS proof with [a] replaced by [b]];
- JAX's _stage_grand_product flag on challenges (beta, gamma) =
  (222222, 333333) and on a gamma that makes a_0 + beta + gamma vanish.

They are what

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_bn254_fs.py -k recompute

prints (as the file's JSON); those tests, skipped without the JAX
package's heavy-test flag, recompute and compare them.

The port's own checks: both verifiers accept; tampered commitments and
evaluations and a wrong nonce are rejected (one verify_bn254_many over
those lanes, with the challenges each FS verifier replays; a single
verify, ~13 s on the CPU, only for a wrong nonce of the BLAKE2b proof and
for the honest Poseidon proof, each equal to its lane); the host replay
equals the prover's challenge; a refused beta/gamma takes the next nonce
and the refusal is raised after JAX's number of attempts; explicit prims
give the default's proof and vk; the proofs round-trip through JAX's
numpy form. The Poseidon proof of rand9 17..25 is lane 0 of prove_many,
one batched pass whose lanes equal prove() of theirs.
"""
import json
import os

import numpy as np
import pytest
import torch

from plonk_tpu_torch.models import fiat_shamir as FS
from plonk_tpu_torch.models import fs_poseidon as FSP
from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models.synthetic import (bn254_mul_circuit, from_words,
                                              words_vec)
from plonk_tpu_torch.ops import poseidon as PO
from plonk_tpu_torch.utils import convert
from plonk_tpu_torch.utils.params import BN254_FR
from test_torch_bn254 import JAX_POINTS, JAX_SCALARS
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

N = 8
SECRET = 987654321
R = BN254_FR.p
CH = words_vec([111111, 222222, 333333, 444444, 555555])
RND = words_vec(range(17, 26))
RND2 = words_vec(range(31, 40))
heavy = pytest.mark.skipif(
    not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
    reason="compiles the JAX BN254 provers and verifier (tens of minutes "
           "of XLA:CPU); set PLONK_TPU_HEAVY_TESTS=1")



def _from_golden(d: dict) -> dict:
    """A recorded proof (hex strings) as fs_fields gives it: points (x, y,
    inf), evaluations, nonce and the challenge [alpha beta gamma z v] as
    ints."""
    out = {k: (int(d[k][0], 16), int(d[k][1], 16), bool(d[k][2]))
           for k in PB.POINT_FIELDS}
    out.update({k: int(d[k], 16) for k in PB.SCALAR_FIELDS})
    out["nonce"] = int(d["nonce"])
    out["challenge"] = [int(c, 16) for c in d["challenge"]]
    return out


def _to_golden(d: dict) -> dict:
    out = {k: [hex(d[k][0]), hex(d[k][1]), d[k][2]] for k in PB.POINT_FIELDS}
    out.update({k: hex(d[k]) for k in PB.SCALAR_FIELDS})
    out["nonce"] = d["nonce"]
    out["challenge"] = [hex(c) for c in d["challenge"]]
    return out


with open(os.path.join(os.path.dirname(__file__), "golden",
                       "bn254_fs_jax.json")) as _f:
    GOLDEN = json.load(_f)
JAX_BLAKE2B = _from_golden(GOLDEN["blake2b"])
JAX_POSEIDON = _from_golden(GOLDEN["poseidon"])
JAX_MANY = [_from_golden(d) for d in GOLDEN["prove_many"]]
JAX_MANY_FLAGS = GOLDEN["verify_many_flags"]
JAX_DENOMINATOR_OK = GOLDEN["denominator_ok"]


def fs_fields(out) -> dict:
    """An FS proof as the recorded dicts hold it."""
    d = {k: (from_words(getattr(out.proof, k).x),
             from_words(getattr(out.proof, k).y),
             bool(getattr(out.proof, k).inf)) for k in PB.POINT_FIELDS}
    d.update({k: from_words(getattr(out.proof, k)) for k in PB.SCALAR_FIELDS})
    d["nonce"] = int(out.nonce)
    d["challenge"] = [from_words(w) for w in np.asarray(out.challenge)]
    return d


def _print_golden(name: str, value) -> None:
    print(json.dumps({name: value}, indent=1))


@pytest.fixture(scope="module", autouse=True)
def _inference():
    """No autograd bookkeeping: the 16-limb arithmetic is tens of thousands
    of tiny ops, and inference mode takes ~20 % off this module's time."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def setup():
    ctx = PB.bn254_setup(N, secret=SECRET, device="cpu")
    return ctx, bn254_mul_circuit(N)


@pytest.fixture(scope="module")
def blake(setup):
    ctx, (sel, cp, a, b, c) = setup
    fs = FS.BN254FsProver(ctx, sel, cp)
    out, diags = fs.prove(a, b, c, RND)
    return fs, out, diags


@pytest.fixture(scope="module")
def many(setup, blake):
    """The Poseidon prover's prove_many at B = 2 (rand9 17..25, 31..39):
    one batched pass whose lane 0 is the single Poseidon proof of these
    inputs."""
    ctx, (sel, cp, a, b, c) = setup
    fs = FSP.BN254PoseidonFsProver(ctx, sel, cp)
    return fs, fs.prove_many(*(np.stack([w, w]) for w in (a, b, c)),
                             np.stack([RND, RND2]))


@pytest.fixture(scope="module")
def poseidon(many):
    fs, outs = many
    return (fs,) + outs[0]


def _swap_a_for_b(proof):
    return proof._replace(a_s=proof.b_s)


def _bump_eval(proof):
    return proof._replace(a_z=torch.as_tensor(words_vec(
        [(from_words(proof.a_z) + 1) % R])[0].astype(np.int64)))


def _replay(kind, ctx, vk, proof, nonce):
    if kind == "blake2b":
        return FS._bn254_derive_from_proof(FS.BN254_LABEL, ctx, list(vk),
                                           proof, nonce)
    return FSP.derive_bn254_challenges_host(ctx, list(vk), proof, nonce)


@pytest.fixture(scope="module")
def interactive(setup, blake):
    """make_prover_bn254 and make_vk_bn254 with explicit prims."""
    ctx, (sel, cp, a, b, c) = setup
    prims = PB._local_prims(ctx)
    proof, diags = PB.make_prover_bn254(ctx, sel, cp, prims=prims)(
        a, b, c, CH, RND)
    return proof, diags, PB.make_vk_bn254(ctx, sel, cp, prims=prims)


# lanes of the batched verify after JAX's four: each FS proof tampered,
# with the challenges its FS verifier replays
TAMPERED = [(kind, what) for kind in ("blake2b", "poseidon")
            for what in ("commitment", "evaluation", "nonce")]


@pytest.fixture(scope="module")
def batch(setup, blake, poseidon, interactive):
    """verify_bn254_many over [interactive, BLAKE2b FS, Poseidon FS, the
    BLAKE2b proof with [a] := [b] and its own challenge (JAX's four
    lanes)] + the TAMPERED lanes."""
    ctx = setup[0]
    vk = blake[0].vk
    outs = {"blake2b": blake[1], "poseidon": poseidon[1]}
    proofs = [interactive[0], blake[1].proof, poseidon[1].proof,
              _swap_a_for_b(blake[1].proof)]
    chs = [CH, blake[1].challenge, poseidon[1].challenge,
           blake[1].challenge]
    for kind, what in TAMPERED:
        out = outs[kind]
        proof = {"commitment": _swap_a_for_b, "evaluation": _bump_eval,
                 "nonce": lambda p: p}[what](out.proof)
        nonce = out.nonce + (what == "nonce")
        proofs.append(proof)
        chs.append(_replay(kind, ctx, vk, proof, nonce))
    flags = PB.verify_bn254_many(ctx, vk, PB.stack_proofs(proofs),
                                 np.stack(chs))
    return flags, proofs, chs


def test_blake2b_proof_matches_recorded_jax(blake):
    _, out, diags = blake
    assert bool(diags.all_ok())
    assert fs_fields(out) == JAX_BLAKE2B


def test_poseidon_proof_matches_recorded_jax(poseidon):
    _, out, diags = poseidon
    assert bool(diags.all_ok())
    assert fs_fields(out) == JAX_POSEIDON


def test_prove_many_matches_recorded_jax(many):
    """Lane i equals JAX's prove_many lane i; JAX's lane 0 equals its
    single proof."""
    outs = many[1]
    assert len(outs) == 2 and all(bool(d.all_ok()) for _, d in outs)
    assert [fs_fields(out) for out, _ in outs] == JAX_MANY
    assert JAX_MANY[0] == JAX_POSEIDON


@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_host_replay_equals_the_challenge(setup, blake, poseidon, kind):
    fs, out, _ = {"blake2b": blake, "poseidon": poseidon}[kind]
    ch = _replay(kind, setup[0], fs.vk, out.proof, out.nonce)
    np.testing.assert_array_equal(ch, out.challenge)
    assert ch.shape == (5, 16) and ch.dtype == np.uint32


def test_blake2b_verify_rejects_a_wrong_nonce(setup, blake, batch):
    """verify_bn254_fs on the proof with the next nonce: rejected, as its
    lane of verify_bn254_many is; the honest proof's lane accepts."""
    ctx = setup[0]
    fs, out, _ = blake
    wrong = out._replace(nonce=out.nonce + 1)
    assert not FS.verify_bn254_fs(ctx, fs.vk, wrong)
    flags = batch[0].tolist()
    assert flags[1] and not flags[4 + TAMPERED.index(("blake2b", "nonce"))]


def test_poseidon_verify_accepts(setup, poseidon, batch):
    """verify_bn254_fs_poseidon accepts, as its lane of verify_bn254_many
    does."""
    ctx = setup[0]
    fs, out, _ = poseidon
    assert FSP.verify_bn254_fs_poseidon(ctx, fs.vk, out)
    assert bool(batch[0][2])


def test_verify_many_matches_recorded_jax(batch):
    """JAX's four lanes give JAX's flags; every tampered lane is
    rejected."""
    flags = batch[0]
    assert flags.dtype == torch.bool and flags.shape == (4 + len(TAMPERED),)
    assert flags[:4].tolist() == JAX_MANY_FLAGS == [True, True, True, False]
    assert not flags[4:].any()


@pytest.mark.parametrize("kind,what", TAMPERED)
def test_tampering_changes_the_replayed_challenge(blake, poseidon, batch,
                                                  kind, what):
    """A tampered commitment or a wrong nonce changes every challenge from
    beta on; a tampered evaluation changes v alone."""
    out = {"blake2b": blake, "poseidon": poseidon}[kind][1]
    ch = batch[2][4 + TAMPERED.index((kind, what))]
    same = (ch == out.challenge).all(-1).tolist()
    assert same == ([True] * 4 + [False] if what == "evaluation"
                    else [False] * 5)


def test_explicit_prims_give_the_default_proof_and_vk(interactive, blake):
    """make_prover_bn254 and make_vk_bn254 with prims=_local_prims(ctx):
    the default prover's proof (the JAX values recorded in
    tests/test_torch_bn254.py) and the FS prover's default vk."""
    proof, diags, vk = interactive
    assert bool(diags.all_ok())
    for name, (x, y) in JAX_POINTS.items():
        pt = getattr(proof, name)
        assert (from_words(pt.x), from_words(pt.y), bool(pt.inf)) == \
            (x, y, False), name
    for name, v in JAX_SCALARS.items():
        assert from_words(getattr(proof, name)) == v, name
    for a, b in zip(vk, blake[0].vk):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def _grand_product_flags(ctx, fs, circuit) -> list:
    """_stage_grand_product's flag on (beta, gamma) = (222222, 333333) and
    on gamma = -(a_0 + beta), which makes the first denominator factor
    a_0 + beta * omega^0 + gamma vanish."""
    _, _, a, b, c = circuit
    Fr = ctx.Fr
    st = PB._stage_prep(ctx, a, b, c, RND, fs._prims, fs._pre)
    beta = 222222
    flags = []
    for gamma in (333333, -(from_words(a[0]) + beta) % R):
        bg = Fr.encode(PB._as_words(words_vec([beta, gamma]), "cpu"))
        z_x, ok = PB._stage_grand_product(ctx, st, bg[0], bg[1], fs._prims)
        assert ok.dtype == torch.bool and ok.shape == ()
        flags.append(bool(ok))
    return flags


def test_denominator_ok_matches_recorded_jax(setup, blake):
    assert _grand_product_flags(setup[0], blake[0], setup[1]) \
        == JAX_DENOMINATOR_OK


def test_blake2b_retry_takes_the_next_nonce(setup, blake, monkeypatch):
    """A vanishing denominator at nonce 0 (forced) makes the prover retry
    with nonce 1, whose challenges the verifier's replay derives; with
    every nonce refused it raises after nonces 0..31, as JAX's does."""
    ctx, (sel, cp, a, b, c) = setup
    fs = blake[0]
    real = PB._stage_grand_product
    calls = []

    def refuse_first(*args):
        z_x, ok = real(*args)
        calls.append(1)
        return z_x, ok & torch.tensor(len(calls) > 1)

    monkeypatch.setattr(PB, "_stage_grand_product", refuse_first)
    out, diags = fs.prove(a, b, c, RND)
    assert out.nonce == 1 and len(calls) == 2 and bool(diags.all_ok())
    np.testing.assert_array_equal(
        _replay("blake2b", ctx, fs.vk, out.proof, 1), out.challenge)
    assert fs_fields(out)["challenge"] != JAX_BLAKE2B["challenge"]
    calls.clear()
    monkeypatch.setattr(PB, "_stage_grand_product",
                        lambda *args: calls.append(1) or
                        (None, torch.tensor(False)))
    with pytest.raises(RuntimeError,
                       match="no admissible beta/gamma in 32 retries"):
        fs.prove(a, b, c, RND)
    assert len(calls) == 32


def test_poseidon_retry_takes_the_next_nonce(setup, monkeypatch):
    """The same for the Poseidon prover: nonce 1 after a forced refusal,
    and 33 attempts (nonces 0..32, JAX's MAX_NONCE) before it raises. The
    control flow is what is tested, so the permutation is replaced, on
    the device and on the host alike, by a cheap stand-in (rotate the
    lanes, add 7): the sponge itself is held against JAX above."""
    ctx, (sel, cp, a, b, c) = setup
    t = 3
    monkeypatch.setattr(PO, "big_permute", lambda F, pp, s: F.add(
        s.roll(1, dims=-2), F.const(7)))
    monkeypatch.setattr(PO.PoseidonHost, "permute", lambda self, s: [
        (s[i - 1] + 7) % R for i in range(t)])
    fs = FSP.BN254PoseidonFsProver(ctx, sel, cp)
    real = PB._stage_grand_product
    calls = []

    def refuse_first(*args):
        z_x, ok = real(*args)
        calls.append(1)
        return z_x, ok & torch.tensor(len(calls) > 1)

    monkeypatch.setattr(PB, "_stage_grand_product", refuse_first)
    out, diags = fs.prove(a, b, c, RND)
    assert out.nonce == 1 and len(calls) == 2 and bool(diags.all_ok())
    np.testing.assert_array_equal(
        _replay("poseidon", ctx, fs.vk, out.proof, 1), out.challenge)
    calls.clear()
    # prove() is prove_many of one lane: the stand-in stage gives a
    # grand product of that batch's shape
    z_x = torch.zeros((1, N + 3, 16), dtype=torch.int64)
    monkeypatch.setattr(PB, "_stage_grand_product",
                        lambda *args: calls.append(1) or
                        (z_x, torch.tensor([False])))
    with pytest.raises(RuntimeError,
                       match="no admissible beta/gamma in 32 retries"):
        fs.prove(a, b, c, RND)
    assert len(calls) == FSP.MAX_NONCE + 1 == 33


@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_fs_proofs_round_trip_through_numpy(blake, poseidon, kind):
    out = {"blake2b": blake, "poseidon": poseidon}[kind][1]
    arr = convert.bn254_fs_proof_to_numpy(out)
    assert type(arr) is type(out) and arr.proof.a_s.x.dtype == np.uint32
    back = (convert.bn254_fs_proof_from_numpy(arr, "cpu")
            if kind == "blake2b"
            else convert.bn254_poseidon_fs_proof_from_numpy(arr, "cpu"))
    assert type(back) is type(out) and fs_fields(back) == fs_fields(out)


# ---- recomputing the JAX values (heavy) ----

def _jax_ctx():
    from plonk_tpu.models import plonk_bn254 as JPB
    return JPB.bn254_setup(N, secret=SECRET, rolled=True)


@heavy
@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_recompute_jax_fs_proof(kind):
    from plonk_tpu.models import fiat_shamir as JFS
    from plonk_tpu.models import fs_poseidon as JFSP
    sel, cp, a, b, c = bn254_mul_circuit(N)
    cls = JFS.BN254FsProver if kind == "blake2b" else \
        JFSP.BN254PoseidonFsProver
    out, diags = cls(_jax_ctx(), sel, cp).prove(a, b, c, RND)
    assert bool(np.asarray(diags.all_ok()))
    got = fs_fields(out)
    _print_golden(kind, _to_golden(got))
    assert got == (JAX_BLAKE2B if kind == "blake2b" else JAX_POSEIDON)


@heavy
def test_recompute_jax_prove_many():
    from plonk_tpu.models import fs_poseidon as JFSP
    sel, cp, a, b, c = bn254_mul_circuit(N)
    outs = JFSP.BN254PoseidonFsProver(_jax_ctx(), sel, cp).prove_many(
        *(np.stack([w, w]) for w in (a, b, c)), np.stack([RND, RND2]))
    got = [fs_fields(out) for out, _ in outs]
    _print_golden("prove_many", [_to_golden(d) for d in got])
    assert got == JAX_MANY


@heavy
def test_recompute_jax_verify_many_flags():
    """JAX's verify_bn254_many on JAX's four lanes, the proofs given as
    the recorded values."""
    import jax.numpy as jnp
    from plonk_tpu.models import plonk_bn254 as JPB
    sel, cp = bn254_mul_circuit(N)[:2]
    inter = {k: (x, y, False) for k, (x, y) in JAX_POINTS.items()}
    inter.update(JAX_SCALARS)
    inter["challenge"] = [111111, 222222, 333333, 444444, 555555]
    tam = dict(JAX_BLAKE2B, a_s=JAX_BLAKE2B["b_s"])
    lanes = [inter, JAX_BLAKE2B, JAX_POSEIDON, tam]
    w = lambda vals: jnp.asarray(words_vec(vals))
    pts = {k: JPB.BigG1Affine(w([l[k][0] for l in lanes]),
                              w([l[k][1] for l in lanes]),
                              jnp.asarray([l[k][2] for l in lanes]))
           for k in PB.POINT_FIELDS}
    proofs = JPB.BN254Proof(**pts, **{k: w([l[k] for l in lanes])
                                      for k in PB.SCALAR_FIELDS})
    chs = jnp.stack([w(l["challenge"]) for l in lanes])
    ctx = _jax_ctx()
    flags = JPB.verify_bn254_many(ctx, JPB.make_vk_bn254(ctx, sel, cp),
                                  proofs, chs)
    _print_golden("verify_many_flags", [bool(f) for f in np.asarray(flags)])
    assert [bool(f) for f in np.asarray(flags)] == JAX_MANY_FLAGS


@heavy
def test_recompute_jax_denominator_ok():
    import jax
    import jax.numpy as jnp
    from plonk_tpu.models import plonk_bn254 as JPB
    sel, cp, a, b, c = bn254_mul_circuit(N)
    ctx = _jax_ctx()
    prims = JPB._local_prims(ctx)
    Fr = ctx.Fr

    def flag(s_, c_, a_, b_, cc_, r_, beta_w, gamma_w):
        pre = JPB.precompute_bn254(ctx, s_, c_, prims)
        st = JPB._stage_prep(ctx, a_, b_, cc_, r_, prims, pre,
                             jnp.zeros((N, 16), jnp.uint32))
        return JPB._stage_grand_product(ctx, st, Fr.encode(beta_w),
                                        Fr.encode(gamma_w), prims)[1]

    run = jax.jit(flag)
    u32 = lambda x: jnp.asarray(x, jnp.uint32)
    beta = 222222
    got = [bool(run(u32(sel), jnp.asarray(cp), u32(a), u32(b), u32(c),
                    u32(RND), u32(words_vec([beta])[0]),
                    u32(words_vec([g])[0])))
           for g in (333333, -(from_words(a[0]) + beta) % R)]
    _print_golden("denominator_ok", got)
    assert got == JAX_DENOMINATOR_OK
