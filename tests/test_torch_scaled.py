"""The whole slice at n = 16: the port's scaled prover and verifier
(plonk_tpu_torch.models.plonk_scaled) against the JAX package's.

JAX's prover runs once per module (a compile of minutes on the CPU); JAX's
verifier is not run, the port's verify covers it. Exact equality: decoded
scalars, points by x/y/inf."""
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
                                           srs_from_numpy, table_from_numpy)

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


@pytest.mark.parametrize("prims", ["fused", "onepass", "mxu2"])
def test_port_proof_under_prims_matches_jax(jax_run, port, prims):
    """The coset transforms through K5 (fused), K6 (onepass) or K7 (mxu2)
    in their own layouts: the proof is JAX's (which does not depend on its
    prims either)."""
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
             "onepass": PS.onepass_prims, "mxu2": PS.mxu2_prims}
    for flag, want in picks.items():
        if flag is None:
            monkeypatch.delenv("PLONK_TPU_NTT", raising=False)
        else:
            monkeypatch.setenv("PLONK_TPU_NTT", flag)
        got = PS._auto_prims(ctx)
        assert (got.ntt8, got.intt8) == (want().ntt8, want().intt8), flag
    assert PS.fused_prims().ntt8 is not PS.default_prims().ntt8
    # the plain-XLA matmul prims are not ported: raise, never fall back
    monkeypatch.setenv("PLONK_TPU_NTT", "mxu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        PS._auto_prims(ctx)
    with pytest.raises(NotImplementedError):
        PS.mxu_prims()


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
