"""The port's toy SRS, its commitments (naive fold, fixed-base multiple
table) and its MSMs (affine and Jacobian Pippenger, ops/msm.py) on
TOY_CURVE: they agree with each other, with the JAX package (points by
x, y and inf, tolerance 0) and with the golden `g1_multiples`,
`srs_g1s`, `srs_g2_s` and `srs5_eval` of tests/golden/plonk_golden.json."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.models import srs as JS
from plonk_tpu.ops import curve as JC
from plonk_tpu.ops import field as JFM
from plonk_tpu.ops import msm as JMSM
from plonk_tpu.utils import params as JPR
from plonk_tpu_torch.models import srs as S
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops import msm as MSM
from plonk_tpu_torch.ops.field import Field
from plonk_tpu_torch.utils.params import GF101, TOY_CURVE

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "plonk_golden.json")))
Fq = Field(GF101)
JFq = JFM.Field(JPR.GF101)
B, L = 4, 12


def _pts(g: C.G1):
    """(x, y, inf) rows of a point batch as numpy arrays."""
    return tuple(np.asarray(c).astype(np.int64).reshape(-1) for c in g)


def _same(a, b) -> None:
    for u, v in zip(_pts(a), _pts(b)):
        np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def case():
    """L bases k_i * G (one of them infinity, two equal, two opposite) and
    a (B, L) scalar batch with zeros and a repeated row."""
    rng = np.random.default_rng(11)
    ks = rng.integers(1, 17, size=L)
    ks[2], ks[5], ks[6], ks[7] = 0, ks[4], 17 - ks[8], ks[8]
    sc = rng.integers(0, 17, size=(B, L))
    sc[0, :4] = 0
    sc[3] = sc[1]
    g = C.g1_generator(TOY_CURVE, Fq, "cpu")
    pts = C.g1_mul(Fq, g, torch.as_tensor(ks), nbits=5)

    def jax_values(ks, sc):
        """JAX's bases, Pippenger (affine, 5-bit window; Jacobian, 2-bit
        windows), naive and table commits of row 2, and the buckets of
        row 1's low 3 bits, in one compiled call."""
        jg = JC.g1_generator(JPR.TOY_CURVE, JFq)
        jpts = JC.g1_mul(JFq, jg, ks, nbits=5)
        return dict(
            pts=jpts,
            pipp=JMSM.msm_pippenger_many(JFq, jpts, sc, window_bits=5,
                                         scalar_bits=5),
            jac=JMSM.msm_pippenger_jac_many(JFq, jpts, sc, 2, 5),
            naive2=JS.srs_commit_naive(JFq, jpts, sc[2], scalar_bits=5),
            table2=JS.srs_commit_table(
                JFq, JS.srs_multiple_table(JFq, jpts, 17), sc[2]),
            buckets1=JMSM.msm_window_buckets(JFq, jpts, sc[1] & 7, 8))

    want = jax.jit(jax_values)(jnp.asarray(ks.astype(np.uint32)),
                               jnp.asarray(sc.astype(np.uint32)))
    return pts, torch.as_tensor(sc), want


def test_bases_match_jax(case):
    pts, _, want = case
    _same(pts, want["pts"])


def test_commit_modes_agree_with_each_other_and_jax(case):
    pts, sc, want = case
    naive = S.srs_commit_naive(Fq, pts, sc, scalar_bits=5)
    table = S.srs_commit_table(Fq, S.srs_multiple_table(Fq, pts, 17), sc)
    pipp = MSM.msm_pippenger(Fq, pts, sc, window_bits=5, scalar_bits=5)
    for got in (naive, table, pipp):
        _same(got, want["pipp"])
    # JAX's naive and table commits of one row
    _same(C.G1(*(c[2] for c in naive)), want["naive2"])
    _same(C.G1(*(c[2] for c in table)), want["table2"])
    # a shorter coefficient vector uses min(len(coeffs), len(g1s)) terms
    short = sc[:, :5]
    _same(S.srs_commit_naive(Fq, pts, short, scalar_bits=5),
          MSM.msm(Fq, C.G1(*(c[:5] for c in pts)), short, 5, 5))


@pytest.mark.parametrize("window_bits,scalar_bits", [(5, 5), (2, 5),
                                                     (3, 8), (1, 5)])
def test_pippenger_windows(case, window_bits, scalar_bits):
    """Every window split gives the naive fold's points, affine and
    Jacobian (Jacobian against JAX's too)."""
    pts, sc, jax_want = case
    want = S.srs_commit_naive(Fq, pts, sc, scalar_bits=5)
    _same(MSM.msm_pippenger(Fq, pts, sc, window_bits, scalar_bits), want)
    jac = MSM.msm_pippenger_jac(Fq, pts, sc, window_bits, scalar_bits)
    _same(jac, want)
    _same(MSM.msm_pippenger_many(Fq, pts, sc, window_bits, scalar_bits),
          want)
    _same(MSM.msm_pippenger_jac_many(Fq, pts, sc, window_bits, scalar_bits),
          want)
    if (window_bits, scalar_bits) == (2, 5):
        _same(jac, jax_want["jac"])


def test_window_buckets_match_jax(case):
    pts, sc, want = case
    _same(MSM.msm_window_buckets(Fq, pts, sc[1] & 7, 8), want["buckets1"])


def test_srs_both_modes_match_jax_and_golden():
    for mode in ("reference", "fixed"):
        srs = S.srs_create(Fq, TOY_CURVE, secret=2, n=6, mode=mode,
                           device="cpu")
        jsrs = JS.srs_create(JFq, JPR.TOY_CURVE, secret=2, n=6, mode=mode)
        assert srs.length == jsrs.length == 7
        _same(srs.g1s, jsrs.g1s)
        for got, want in ((srs.g2_1, jsrs.g2_1), (srs.g2_s, jsrs.g2_s)):
            assert (int(got.x), int(got.y)) == (int(want.x), int(want.y))
    ref = S.srs_create(Fq, TOY_CURVE, secret=2, n=6, mode="reference",
                       device="cpu")
    for i, exp in enumerate(GOLDEN["srs_g1s"]):
        assert bool(ref.g1s.inf[i]) == exp["inf"]
        assert (int(ref.g1s.x[i]), int(ref.g1s.y[i])) == (exp["x"], exp["y"])
    for name, pt in (("srs_g2_1", ref.g2_1), ("srs_g2_s", ref.g2_s)):
        assert (int(pt.x), int(pt.y)) == (GOLDEN[name]["x"],
                                          GOLDEN[name]["y"])
    assert (GOLDEN["srs_g2_s"]["x"], GOLDEN["srs_g2_s"]["y"]) == (90, 82)


def test_g1_multiples_golden():
    """k * G for every k in [0, len) by the multiple table, the ladder and
    Pippenger, against the golden list."""
    g = C.g1_generator(TOY_CURVE, Fq, "cpu")
    want = GOLDEN["g1_multiples"]
    ks = torch.arange(len(want))
    one = C.G1(g.x[None], g.y[None], g.inf[None])
    tbl = S.srs_multiple_table(Fq, one, len(want))
    ladder = C.g1_mul(Fq, g, ks, nbits=6)
    pipp = MSM.msm_pippenger(Fq, one, ks[:, None], window_bits=3,
                             scalar_bits=6)
    for got in (C.G1(tbl.x[0], tbl.y[0], tbl.inf[0]), ladder, pipp):
        x, y, inf = _pts(got)
        assert [dict(x=int(a), y=int(b), inf=bool(c))
                for a, b, c in zip(x, y, inf)] == want


def test_srs5_eval_golden():
    """src/srs-test.c: secret 5, n 5, polynomial [1, 2, 3] on the
    reference (degenerate) SRS commits to infinity in every mode."""
    srs = S.srs_create(Fq, TOY_CURVE, secret=5, n=5, mode="reference",
                       device="cpu")
    poly = torch.tensor([1, 2, 3])
    for ev in (S.srs_commit_naive(Fq, srs.g1s, poly, scalar_bits=5),
               S.srs_commit_table(Fq, S.srs_multiple_table(Fq, srs.g1s, 17),
                                  poly),
               MSM.msm(Fq, C.G1(*(c[:3] for c in srs.g1s)), poly, 5, 5)):
        assert bool(ev.inf) == GOLDEN["srs5_eval"]["inf"] is True
