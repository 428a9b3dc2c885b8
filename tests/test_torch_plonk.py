"""The port's toy PLONK prover and verifier (models/plonk.py,
models/verifier.py, models/presets.py) against the golden reference run
(tests/golden/plonk_golden.json) and the JAX package, word for word
(tolerance 0: scalars as ints, points by x, y and inf).

JAX's values come from one compiled call per dialect (each proving the
canonical challenge and one where the reference dialect's quadratic r3
term is live) and one compiled verify_flags, all on a fixed SRS with
n_srs = 12 (the live r3 term needs degree 2n + 2); JAX's commit modes give
equal points (its own tests assert it), so every port commit mode is held
against them."""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.models import constraints as JCS
from plonk_tpu.models import plonk as JPL
from plonk_tpu.models import presets as JPRS
from plonk_tpu.models import verifier as JV
from plonk_tpu.ops import curve as JC
from plonk_tpu.utils.params import TOY_PLONK as J_TOY_PLONK
from plonk_tpu_torch.models import constraints as CS
from plonk_tpu_torch.models import plonk as PL
from plonk_tpu_torch.models import verifier as V
from plonk_tpu_torch.models.presets import (
    CANONICAL_CHALLENGE, CANONICAL_RAND, canonical_assignments,
    canonical_constraints, canonical_context)
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import Field
from plonk_tpu_torch.utils import convert
from plonk_tpu_torch.utils.params import HF17, TOY_PLONK

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "plonk_golden.json")))
LIVE_R3 = np.array([3, 7, 11, 2, 6])          # the dialects diverge here
CHALLENGES = np.stack([CANONICAL_CHALLENGE, LIVE_R3])
MODES = {"naive": dict(), "table": dict(commit_mode="table"),
         "pippenger": dict(use_pippenger=True)}
Fr = Field(HF17)


def big_context(**kw):
    return PL.plonk_new(TOY_PLONK, secret=2, n_srs=12, h_len=4,
                        srs_mode="fixed", device="cpu", **kw)


def _ints(x):
    return np.asarray(x).astype(np.int64)


def assert_proofs_equal(p, q, lane=None):
    """Word equality of two proofs; `lane` picks one proof of a batched
    `q`."""
    pick = (lambda a: a) if lane is None else (lambda a: a[lane])
    for f in PL.POINT_FIELDS:
        for k in range(3):
            np.testing.assert_array_equal(_ints(getattr(p, f)[k]),
                                          _ints(pick(getattr(q, f)[k])), f)
    for f in PL.SCALAR_FIELDS:
        np.testing.assert_array_equal(_ints(getattr(p, f)),
                                      _ints(pick(getattr(q, f))), f)


def assert_diags_equal(d, e, lane=None):
    pick = (lambda a: a) if lane is None else (lambda a: a[lane])
    assert [bool(x) for x in d] == [bool(pick(y)) for y in e]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's context, its proofs of both dialects at CHALLENGES (vmapped),
    and its verify_flags compiled once (on a VerificationKey passed in)."""
    ctx = JPL.plonk_new(J_TOY_PLONK, secret=2, n_srs=12, h_len=4,
                        srs_mode="fixed")
    cons, asg = JPRS.canonical_constraints(), JPRS.canonical_assignments()
    sel = cons.selectors_device()
    selectors = jnp.stack([sel[k] for k in ("q_l", "q_r", "q_o", "q_m",
                                            "q_c")])
    copies = jnp.stack([jnp.asarray(cons.c_a), jnp.asarray(cons.c_b),
                        jnp.asarray(cons.c_c)])
    a, b, c = asg.device()
    rnd = jnp.asarray(CANONICAL_RAND.astype(np.uint32))
    chs = jnp.asarray(CHALLENGES.astype(np.uint32))
    proofs = {}
    for dialect in ("reference", "standard"):
        proofs[dialect] = jax.jit(jax.vmap(
            lambda ch, d=dialect: JPL.prove_core(
                ctx, selectors, copies, a, b, c, ch, rnd, dialect=d)))(chs)
    vk_fields = [f.name for f in dataclasses.fields(JV.VerificationKey)]
    verify = jax.jit(lambda vk, proof, ch: JV.verify_flags(
        ctx, JV.VerificationKey(*vk, n=4), proof, ch))
    return dict(ctx=ctx, cons=cons, proofs=proofs, verify=verify,
                vk_fields=vk_fields[:-1])


def _jax_point(pt, two_d=False):
    x, y = jnp.asarray(_ints(pt.x).astype(np.uint32)), jnp.asarray(
        _ints(pt.y).astype(np.uint32))
    return JC.G2(x, y) if two_d else JC.G1(x, y, jnp.asarray(
        np.asarray(pt.inf)))


def _jax_flags(jax_side, vk, proof, ch):
    """JAX's verify_flags on the port's key and proof."""
    jvk = tuple(_jax_point(getattr(vk, f), f.startswith("g2"))
                for f in jax_side["vk_fields"])
    jproof = JPL.Proof(**{f: (_jax_point(getattr(proof, f))
                              if f in PL.POINT_FIELDS
                              else jnp.asarray(np.uint32(int(getattr(
                                  proof, f)))))
                          for f in PL.Proof._fields})
    ok1, ok2 = jax_side["verify"](jvk, jproof, jnp.asarray(
        np.asarray(ch).astype(np.uint32)))
    return bool(ok1), bool(ok2)


# ---------------- golden ----------------

@pytest.mark.parametrize("mode", list(MODES))
def test_canonical_proof_equals_golden(mode):
    """The reference SRS (every G1 power at infinity) and the reference
    dialect: nine infinite commitments and the tail 15/13/5/1/12/15/15."""
    ctx = canonical_context(device="cpu", **MODES[mode])
    proof, diags = PL.prove(ctx, canonical_constraints(),
                            canonical_assignments(), CANONICAL_CHALLENGE,
                            CANONICAL_RAND)
    assert bool(diags.all_ok())
    want = GOLDEN["proof"]
    for f in PL.POINT_FIELDS:
        pt = getattr(proof, f)
        assert (int(pt.x), int(pt.y), bool(pt.inf)) == (
            want[f]["x"], want[f]["y"], want[f]["inf"]) == (0, 0, True), f
    tail = [int(getattr(proof, f)) for f in PL.SCALAR_FIELDS]
    assert tail == [want[f] for f in PL.SCALAR_FIELDS] == [15, 13, 5, 1, 12,
                                                           15, 15]


def test_canonical_intermediates_equal_golden():
    """What the port exposes of the intermediates: the domains, z_H, the
    sigma mappings, the 11 interpolations and L1."""
    ctx = canonical_context(device="cpu")
    h, k1h, k2h = ctx.domains_host()
    assert (list(h), list(k1h), list(k2h)) == (GOLDEN["h"], GOLDEN["k1_h"],
                                               GOLDEN["k2_h"])
    z_h = list(ctx.z_h_coeffs())
    assert z_h == GOLDEN["z_h_x"]
    cons, asg = canonical_constraints(), canonical_assignments()
    for i, copy in enumerate((cons.c_a, cons.c_b, cons.c_c)):
        assert PL.sigma_to_roots(ctx, copy).tolist() == \
            GOLDEN[f"sigma_{i + 1}"]
    sel = cons.selectors_device("cpu")
    rows = {"f_a_x": asg.a, "f_b_x": asg.b, "f_c_x": asg.c,
            **{f"{k}_x": sel[k] for k in ("q_o", "q_m", "q_l", "q_r",
                                          "q_c")},
            **{f"s_sigma_{i}": GOLDEN[f"sigma_{i}"] for i in (1, 2, 3)}}
    for name, vals in rows.items():
        got = N.interpolate(Fr, torch.as_tensor(_ints(vals)), 4).tolist()
        while len(got) > 1 and got[-1] == 0:
            got.pop()
        assert got == GOLDEN[name], name
    e0 = torch.tensor([1, 0, 0, 0])
    assert N.interpolate(Fr, e0, 4).tolist() == GOLDEN["l_1_x"]


# ---------------- JAX parity ----------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dialect", ["reference", "standard"])
def test_proofs_equal_jax(jax_side, dialect, mode):
    ctx = big_context(**MODES[mode])
    cons, asg = canonical_constraints(), canonical_assignments()
    jproofs, jdiags = jax_side["proofs"][dialect]
    for lane, ch in enumerate(CHALLENGES):
        proof, diags = PL.prove(ctx, cons, asg, ch, CANONICAL_RAND,
                                dialect=dialect)
        assert_proofs_equal(proof, jproofs, lane)
        assert_diags_equal(diags, jdiags, lane)
        assert bool(diags.all_ok())
    # the dialects coincide at the canonical challenge and differ at LIVE_R3
    ref, std = (jax_side["proofs"][d][0].r_z for d in ("reference",
                                                        "standard"))
    assert int(ref[0]) == int(std[0]) and int(ref[1]) != int(std[1])


def test_prove_core_on_tensors_equals_prove(jax_side):
    """prove_core on (5, n) selectors and (3, n, 2) copies, from the
    frontend's arrays (constraints_to_tensors)."""
    ctx = big_context()
    sel, cp = CS.constraints_to_tensors(canonical_constraints())
    asg = canonical_assignments()
    proof, _ = PL.prove_core(ctx, sel, cp, asg.a, asg.b, asg.c, LIVE_R3,
                             CANONICAL_RAND, dialect="standard")
    assert_proofs_equal(proof, jax_side["proofs"]["standard"][0], 1)
    with pytest.raises(ValueError):
        PL.prove_core(ctx, sel, cp, asg.a, asg.b, asg.c, LIVE_R3,
                      CANONICAL_RAND, dialect="paper")


def test_verify_and_flags_equal_jax(jax_side):
    """The standard dialect on the fixed SRS: verify accepts, rejects
    r_z + 1, a swapped commitment and a wrong challenge; verify_flags
    equals JAX's flags on the same key and proofs."""
    ctx = big_context()
    cons, asg = canonical_constraints(), canonical_assignments()
    vk = V.make_verification_key(ctx, cons)
    for ch in CHALLENGES:
        proof = PL.prove_checked(ctx, cons, asg, ch, CANONICAL_RAND,
                                 dialect="standard")
        assert V.verify(ctx, vk, proof, ch)
        bad_r = proof._replace(r_z=(proof.r_z + 1) % 17)
        assert not (bool(proof.a_s.x == proof.b_s.x)
                    and bool(proof.a_s.y == proof.b_s.y))
        swapped = proof._replace(a_s=proof.b_s, b_s=proof.a_s)
        for p in (proof, bad_r, swapped):
            flags = tuple(bool(f) for f in V.verify_flags(ctx, vk, p, ch))
            assert flags == _jax_flags(jax_side, vk, p, ch)
        assert not V.verify(ctx, vk, bad_r, ch)
        assert not V.verify(ctx, vk, swapped, ch)
    assert not V.verify(ctx, vk, proof, CHALLENGES[0])   # proof at LIVE_R3
    # the reference dialect's quadratic r3 term fails the verifier
    ref = PL.prove_checked(ctx, cons, asg, LIVE_R3, CANONICAL_RAND)
    assert not V.verify(ctx, vk, ref, LIVE_R3)


def test_verify_canonical_context():
    """canonical_context("fixed"): prove -> verify accepts, tampered
    proofs are rejected."""
    ctx = canonical_context(srs_mode="fixed", device="cpu")
    cons, asg = canonical_constraints(), canonical_assignments()
    proof = PL.prove_checked(ctx, cons, asg, CANONICAL_CHALLENGE,
                             CANONICAL_RAND, dialect="standard")
    vk = V.make_verification_key(ctx, cons)
    assert vk.n == 4 and int(vk.g2_s.x) == int(ctx.srs.g2_s.x)
    assert V.verify(ctx, vk, proof, CANONICAL_CHALLENGE)
    assert not V.verify(ctx, vk, proof._replace(
        r_z=(proof.r_z + 1) % 17), CANONICAL_CHALLENGE)
    assert not V.verify(ctx, vk, proof._replace(a_s=proof.c_s),
                        CANONICAL_CHALLENGE)


def test_prove_checked_raises_as_jax():
    """A bad witness raises the witness-check error; the reference
    dialect at LIVE_R3 on the canonical SRS exceeds the SRS degree (the
    reference's srs.h:54-56 exit) and raises that error instead."""
    ctx = canonical_context(srs_mode="fixed", device="cpu")
    cons = canonical_constraints()
    bad = canonical_assignments()
    bad.c = bad.c.copy()
    bad.c[0] = 10
    with pytest.raises(AssertionError, match="constraints not satisfied"):
        PL.prove_checked(ctx, cons, bad, CANONICAL_CHALLENGE, CANONICAL_RAND)
    _, diags = PL.prove(ctx, cons, bad, CANONICAL_CHALLENGE, CANONICAL_RAND)
    assert not bool(diags.satisfied) and not bool(diags.all_ok())
    with pytest.raises(AssertionError, match="exceeds SRS size"):
        PL.prove_checked(ctx, cons, canonical_assignments(), LIVE_R3,
                         CANONICAL_RAND)
    # the same messages as the JAX package's prove_checked
    import inspect
    src = inspect.getsource(JPL.prove_checked)
    for msg in ("constraints not satisfied by assignments",
                "polynomial degree exceeds SRS size",
                "grand-product accumulator check failed",
                "non-zero remainder in t(x) division",
                "non-zero remainder in opening division"):
        assert msg in src and msg in inspect.getsource(PL.prove_checked)


def test_context_domain_checks():
    srs = canonical_context(device="cpu").srs
    for bad in (dict(omega=2), dict(k1=4), dict(k2=13), dict(k2=8)):
        params = dataclasses.replace(TOY_PLONK, **bad)
        with pytest.raises(ValueError):
            PL.PlonkContext(params=params, srs=srs, h_len=4)
    with pytest.raises(ValueError):
        PL.PlonkContext(params=TOY_PLONK, srs=srs, h_len=3)


def test_table_is_cached_on_the_context():
    ctx = canonical_context(srs_mode="fixed", commit_mode="table",
                            device="cpu")
    coeffs = torch.tensor([[1, 2, 3], [4, 5, 6]])
    first = PL._commit(ctx, coeffs)
    table = ctx._multiple_table
    assert table.x.shape == (7, 17)
    again = PL._commit(ctx, coeffs)
    assert ctx._multiple_table is table
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    other = canonical_context(srs_mode="fixed", commit_mode="table",
                              device="cpu")
    assert getattr(other, "_multiple_table", None) is None


def test_entry_points_need_cuda_or_cpu():
    """Without device="cpu" the entry points run on the card, and raise
    where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from plonk_tpu_torch.models.srs import srs_create
    from plonk_tpu_torch.utils.params import GF101, TOY_CURVE
    with pytest.raises(RuntimeError, match="device='cpu'"):
        canonical_context()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.plonk_new(TOY_PLONK, secret=2, n_srs=6, h_len=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srs_create(Field(GF101), TOY_CURVE, 2, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CS.satisfies(Fr, canonical_constraints(), canonical_assignments())


# ---------------- utils/convert.py round trips ----------------

def test_convert_round_trips(jax_side):
    """JAX's toy SRS, constraints, proof and diagnostics go in and out
    again, word-equal; the SRS that comes in proves the port's proof."""
    jctx = jax_side["ctx"]
    srs_np = convert.srs_to_numpy(jctx.srs)
    srs = convert.srs_from_numpy(**srs_np, device="cpu")
    back = convert.srs_to_numpy(srs)
    for k in ("g1_x", "g1_y", "g1_inf"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(
            jctx.srs.g1s, k[3:])))
    for k in ("g2_1", "g2_s"):
        pt = getattr(jctx.srs, k)
        assert (int(back[k][0]), int(back[k][1])) == (int(pt.x), int(pt.y))
    assert back["mode"] == "fixed" and srs.length == 13
    mine = big_context().srs
    for a, b in zip(mine.g1s, srs.g1s):
        assert torch.equal(a, b)

    cons = convert.constraints_from_numpy(jax_side["cons"])
    out = convert.constraints_to_numpy(cons)
    jback = JCS.Constraints(**out)
    for f in out:
        np.testing.assert_array_equal(getattr(jback, f),
                                      getattr(jax_side["cons"], f))
        np.testing.assert_array_equal(getattr(cons, f),
                                      getattr(canonical_constraints(), f))

    jproofs, jdiags = jax_side["proofs"]["standard"]
    jproof = jax.tree_util.tree_map(lambda a: a[1], jproofs)
    proof = convert.proof_from_numpy(jproof, "cpu")
    assert_proofs_equal(convert.proof_to_numpy(proof), jproof)
    ctx = PL.PlonkContext(params=TOY_PLONK, srs=srs, h_len=4)
    mine, _ = PL.prove(ctx, cons, canonical_assignments(), LIVE_R3,
                       CANONICAL_RAND, dialect="standard")
    assert_proofs_equal(mine, proof)
    diags = convert.diagnostics_from_numpy(
        jax.tree_util.tree_map(lambda a: a[1], jdiags), "cpu")
    assert bool(diags.all_ok())
    assert_diags_equal(convert.diagnostics_to_numpy(diags), diags)
