"""The whole slice at n = 16: the port's scaled prover and verifier
(plonk_tpu_torch.models.plonk_scaled) against the JAX package's.

JAX's prover runs once per module (a compile of minutes on the CPU); JAX's
verifier is not run, the port's verify covers it. Exact equality: decoded
scalars, points by x/y/inf."""
import ast
import inspect
import os
import textwrap

import numpy as np
import pytest
import torch

from plonk_tpu.models import plonk_scaled as JPS
from plonk_tpu.models.synthetic import square_chain_circuit as j_circuit
from plonk_tpu.utils.params import SCALED_CURVE, SCALED_FR
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.synthetic import square_chain_circuit
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.ops import pairing as PR
from plonk_tpu_torch.utils.convert import (proof_from_numpy, proof_to_numpy,
                                           srs_from_numpy, srs_to_numpy,
                                           table_from_numpy)

N = 16
CH = [1111, 2222, 3333, 4444, 5555]
RND = list(range(1, 10))
# the JAX package's proof for (N, CH, RND), decoded
ANCHOR_SCALARS = dict(a_z=11535495, b_z=4125738, c_z=8864595,
                      s_sigma_1_z=31108, s_sigma_2_z=85023238,
                      r_z=91913729, z_omega_z=29775783)
ANCHOR_POINTS = dict(a_s=(1379689719, 1885742547),
                     w_z_omega_s=(1642674468, 1818070622))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's context, window table and make_prover proof, as numpy."""
    ctx = JPS.scaled_new(N)
    sel, cp, a, b, c = j_circuit(SCALED_FR.p, N)
    proof, diags = JPS.make_prover(ctx, sel, cp)(a, b, c, CH, RND)
    assert bool(diags.all_ok())
    g1s, tbl = ctx.srs.g1s, JPS.fixed_base_table(ctx)
    return dict(
        srs=(np.asarray(g1s.x), np.asarray(g1s.y), np.asarray(g1s.inf),
             (np.asarray(ctx.srs.g2_1.x), np.asarray(ctx.srs.g2_1.y)),
             (np.asarray(ctx.srs.g2_s.x), np.asarray(ctx.srs.g2_s.y))),
        table=(np.asarray(tbl.x), np.asarray(tbl.y), np.asarray(tbl.inf),
               int(tbl.window_bits)),
        proof=proof_from_numpy(proof, "cpu"))


@pytest.fixture(scope="module")
def port():
    ctx = PS.scaled_new(N, device="cpu")
    sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, N)
    proof, diags = PS.make_prover(ctx, sel, cp)(a, b, c, CH, RND)
    return dict(ctx=ctx, circuit=(sel, cp, a, b, c), proof=proof,
                diags=diags)


def _assert_proofs_equal(got, want):
    for name in POINT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert bool(g.inf) == bool(w.inf), name
        assert (int(g.x), int(g.y)) == (int(w.x), int(w.y)), name
    for name in SCALAR_FIELDS:
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def test_port_proof_matches_jax_prover(jax_run, port):
    # the JAX SRS carried across equals the port's own srs_create
    x, y, inf, g2_1, g2_s = jax_run["srs"]
    srs = srs_from_numpy(x, y, inf, g2_1, g2_s, "fixed", "cpu")
    own = port["ctx"].srs
    for a, b in zip(tuple(srs.g1s) + tuple(srs.g2_1) + tuple(srs.g2_s),
                    tuple(own.g1s) + tuple(own.g2_1) + tuple(own.g2_s)):
        assert torch.equal(a, b)
    # the port's proof equals JAX's, from the port's SRS and from JAX's
    _assert_proofs_equal(port["proof"], jax_run["proof"])
    ctx = PS.ScaledContext(params=port["ctx"].params, srs=srs, n=N)
    sel, cp, a, b, c = port["circuit"]
    proof, _ = PS.make_prover(ctx, sel, cp)(a, b, c, CH, RND)
    _assert_proofs_equal(proof, jax_run["proof"])
    # JAX's own window table (another window width) commits the same
    tbl = table_from_numpy(*jax_run["table"], device="cpu")
    prims = PS.default_prims()._replace(
        commit_many=PS.table_commit(ctx, tbl))
    proof, _ = PS.prove_scaled(ctx, sel, cp, a, b, c, CH, RND, prims=prims)
    _assert_proofs_equal(proof, jax_run["proof"])


@pytest.mark.parametrize("prims", ["fused", "onepass", "mxu", "mxu2"])
def test_port_proof_under_prims_matches_jax(jax_run, port, prims):
    """The coset transforms through K5 (fused), K6 (onepass), plain matmul
    products (mxu) or K7 (mxu2) in their own layouts: the proof is JAX's
    (which does not depend on its prims either)."""
    ctx = port["ctx"]
    sel, cp, a, b, c = port["circuit"]
    prover = PS.make_prover(ctx, sel, cp,
                            prims=getattr(PS, f"{prims}_prims")())
    proof, diags = prover(a, b, c, CH, RND)
    assert bool(diags.all_ok())
    _assert_proofs_equal(proof, jax_run["proof"])


def test_auto_prims_reads_plonk_tpu_ntt(monkeypatch):
    ctx = object()
    picks = {None: PS.default_prims, "blocked": PS.default_prims,
             "other": PS.default_prims, "fused": PS.fused_prims,
             "onepass": PS.onepass_prims, "mxu": PS.mxu_prims,
             "mxu2": PS.mxu2_prims}
    for flag, want in picks.items():
        if flag is None:
            monkeypatch.delenv("PLONK_TPU_NTT", raising=False)
        else:
            monkeypatch.setenv("PLONK_TPU_NTT", flag)
        got = PS._auto_prims(ctx)
        assert (got.ntt8, got.intt8) == (want().ntt8, want().intt8), flag
    assert PS.fused_prims().ntt8 is not PS.default_prims().ntt8
    assert PS.mxu_prims().ntt8 is not PS.mxu2_prims().ntt8


def test_port_proof_matches_anchors(port):
    proof, ctx = port["proof"], port["ctx"]
    assert bool(port["diags"].all_ok())
    for name, want in ANCHOR_SCALARS.items():
        assert int(getattr(proof, name)) == want, name
    for name, want in ANCHOR_POINTS.items():
        pt = getattr(proof, name)
        assert not bool(pt.inf)
        assert (int(ctx.Fq.decode(pt.x)), int(ctx.Fq.decode(pt.y))) == want
    # the numpy round trip is lossless
    _assert_proofs_equal(proof_from_numpy(proof_to_numpy(proof), "cpu"),
                         proof)
    # all-zero public inputs ride an extra transform row: same proof
    sel, cp, a, b, c = port["circuit"]
    with_pi, diags = PS.make_prover(ctx, sel, cp)(
        a, b, c, CH, RND, public_inputs=np.zeros(N, dtype=np.uint32))
    assert bool(diags.all_ok())
    _assert_proofs_equal(with_pi, proof)


def test_srs_reference_mode_matches_jax():
    """The degenerate reference-mode SRS: all G1 powers at infinity,
    G2 side from the raw secret."""
    from plonk_tpu.models.srs import srs_create as j_srs_create
    from plonk_tpu.ops.field import MontField as JMontField
    from plonk_tpu_torch.models.srs import srs_create
    Fq = MontField(SCALED_CURVE.base)
    got = srs_create(Fq, SCALED_CURVE, 123456789, 4, mode="reference",
                     device="cpu")
    want = j_srs_create(JMontField(SCALED_CURVE.base), SCALED_CURVE,
                        123456789, 4, mode="reference")
    assert bool(got.g1s.inf.all()) and got.length == 5
    for a, b in zip(tuple(got.g1s) + tuple(got.g2_1) + tuple(got.g2_s),
                    tuple(want.g1s) + tuple(want.g2_1) + tuple(want.g2_s)):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(a.numpy().dtype))


def test_port_verify_accepts_and_rejects_tampered(port):
    ctx, proof = port["ctx"], port["proof"]
    sel, cp = port["circuit"][:2]
    vk = PS.make_vk_scaled(ctx, sel, cp)
    assert PS.verify_scaled(ctx, vk, proof, CH)
    bad = proof._replace(r_z=(proof.r_z + 1) % SCALED_FR.p)
    assert not PS.verify_scaled(ctx, vk, bad, CH)


def test_port_pairing_bilinear():
    Fq = MontField(SCALED_CURVE.base)
    g1 = C.g1_generator(SCALED_CURVE, Fq, "cpu")
    g2 = C.g2_generator(SCALED_CURVE, Fq, "cpu")
    e = PR.pairing(Fq, SCALED_CURVE, g1, g2)
    assert not bool(C.gt_equal(e, C.GT.one(Fq, (), "cpu")))
    for a in (7, 12345):
        left = PR.pairing(Fq, SCALED_CURVE, C.g1_mul(Fq, g1, a), g2)
        right = PR.pairing(Fq, SCALED_CURVE, g1,
                           C.g2_mul(Fq, SCALED_CURVE.d, g2, a))
        assert bool(C.gt_equal(left, C.gt_pow_static(Fq, SCALED_CURVE.d,
                                                     e, a)))
        assert bool(C.gt_equal(left, right))


def _jax_check_messages() -> list:
    """The messages of JAX's prove_scaled_checked, in source order."""
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(JPS.prove_scaled_checked)))
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", None) == "check"]
    return [c.args[1].value for c in sorted(calls, key=lambda c: c.lineno)]


@pytest.mark.parametrize("case", ["tag", "index 0", "index n + 1",
                                  "unsatisfied", "permutation broken"])
def test_prove_scaled_checked_refuses_bad_input(port, case):
    """Bad copies raise JAX's message before any gather (an index out of
    range would raise IndexError there); a witness that breaks a gate or
    the copy permutation raises the diagnostic's."""
    ctx = port["ctx"]
    sel, cp, a, b, c = (np.array(x) for x in port["circuit"])
    tag, index, satisfied, tail = _jax_check_messages()[:4]
    want = {"tag": tag, "index 0": index, "index n + 1": index,
            "unsatisfied": satisfied, "permutation broken": tail}[case]
    if case == "tag":
        cp[1, 3, 0] = 3
    elif case.startswith("index"):
        cp[0, 5, 1] = 0 if case == "index 0" else N + 1
    elif case == "unsatisfied":
        c[2] = (c[2] + 1) % SCALED_FR.p
    else:
        cp[2, N - 1] = (0, 1)       # C_{n-1} also copies A_0: no permutation
    with pytest.raises(ValueError) as err:
        PS.prove_scaled_checked(ctx, sel, cp, a, b, c, CH, RND)
    assert str(err.value) == want


@pytest.mark.parametrize("flag", PS.ScaledDiagnostics._fields)
def test_prove_scaled_checked_diagnostic_messages(port, monkeypatch, flag):
    """Each diagnostic that fails raises JAX's message for it; with all of
    them holding the checked prover returns make_prover's proof."""
    ctx = port["ctx"]
    sel, cp, a, b, c = port["circuit"]
    proof, diags = PS.prove_scaled_checked(ctx, sel, cp, a, b, c, CH, RND)
    assert bool(diags.all_ok())
    _assert_proofs_equal(proof, port["proof"])
    real = PS.prove_scaled

    def failing(*args, **kw):
        p, d = real(*args, **kw)
        return p, d._replace(**{flag: torch.tensor(False)})

    monkeypatch.setattr(PS, "prove_scaled", failing)
    with pytest.raises(ValueError) as err:
        PS.prove_scaled_checked(ctx, sel, cp, a, b, c, CH, RND)
    want = _jax_check_messages()[2 + PS.ScaledDiagnostics._fields.index(
        flag)]
    assert str(err.value) == want


def test_verify_scaled_many_lane_by_lane(port):
    """Lanes: the proof, the proof with r_z tampered, a proof with other
    blinding, and the proof under another challenge: (B,) flags, lane i
    verify_scaled's of lane i, with and without (zero) public inputs."""
    ctx, proof = port["ctx"], port["proof"]
    sel, cp, a, b, c = port["circuit"]
    vk = PS.make_vk_scaled(ctx, sel, cp)
    other, diags = PS.make_prover(ctx, sel, cp)(a, b, c, CH,
                                                [v + 9 for v in RND])
    assert bool(diags.all_ok())
    bad = proof._replace(r_z=(proof.r_z + 1) % SCALED_FR.p)
    lanes = [proof, bad, other, proof]
    chs = np.array([CH, CH, CH, CH[:4] + [CH[4] + 1]])
    got = PS.verify_scaled_many(ctx, vk, PS.stack_proofs(lanes), chs)
    assert got.shape == (4,) and got.tolist() == [True, False, True, False]
    zeros = np.zeros((4, N), dtype=np.uint32)
    assert PS.verify_scaled_many(ctx, vk, PS.stack_proofs(lanes), chs,
                                 public_inputs=zeros).tolist() == got.tolist()
    for lane, ch, want in zip(lanes, chs, got.tolist()):
        assert PS.verify_scaled(ctx, vk, lane, ch) == want


def test_table_cache_is_jax_s(port, tmp_path, monkeypatch):
    """The window table's cache file has JAX's key
    (_fb_cache_path(ctx, pts, 4, pallas=True)) and fields: JAX loads the
    port's file word for word, the port loads JAX's without building, and
    a corrupt file is rebuilt over."""
    monkeypatch.setenv("PLONK_TPU_CACHE", str(tmp_path))
    ctx = port["ctx"]
    fresh = lambda: PS.ScaledContext(params=ctx.params, srs=ctx.srs, n=N)
    srs = srs_to_numpy(ctx.srs)
    pts = C.G1(srs["g1_x"], srs["g1_y"], srs["g1_inf"])
    path = PS._fb_cache_path(ctx, 4)
    assert path == JPS._fb_cache_path(ctx, pts, 4, pallas=True)
    tbl = PS.fixed_base_table(fresh())
    assert os.path.exists(path) and os.listdir(tmp_path) == [
        os.path.basename(path)]
    jtbl = JPS._fb_disk_load(ctx, pts, 4, pallas=True)
    for k in range(3):
        np.testing.assert_array_equal(np.asarray(jtbl[k]), tbl[k].numpy())
    os.remove(path)
    JPS._fb_disk_save(ctx, pts, 4, jtbl, pallas=True)
    build = PS.build_commit_table
    monkeypatch.setattr(PS, "build_commit_table", None)
    loaded = PS.fixed_base_table(fresh())
    for k in range(3):
        assert torch.equal(loaded[k], tbl[k])
    assert loaded.window_bits == 4 and loaded.packed is None
    with open(path, "wb") as f:
        f.write(b"not an npz")
    monkeypatch.setattr(PS, "build_commit_table", build)
    rebuilt = PS.fixed_base_table(fresh())
    for k in range(3):
        assert torch.equal(rebuilt[k], tbl[k])
    assert JPS._fb_disk_load(ctx, pts, 4, pallas=True) is not None
