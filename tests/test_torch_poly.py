"""Parity of the port's polynomial helpers (ops/poly.py), the toy NTT
helpers (interpolate, evaluate_on_domain, ntt_mul) and ops/matrix.py with
the JAX package, on F17 (direct Field) and BabyBear (MontField): the same
words (tolerance 0). Also: a leading batch dimension gives each row's
own result, and INTT equals the inverse Vandermonde matrix and the golden
h_pows_inv."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import field as JFM
from plonk_tpu.ops import matrix as JMX
from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops import poly as JP
from plonk_tpu.utils import params as JPR
from plonk_tpu_torch.ops import field as FM
from plonk_tpu_torch.ops import matrix as MX
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops import poly as P
from plonk_tpu_torch.utils import params as PR

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "plonk_golden.json")))
FIELDS = ["HF17", "BABYBEAR"]


def _fields(name):
    return FM.make_field(getattr(PR, name)), JFM.make_field(getattr(JPR,
                                                                    name))


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _eq(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _words(F, rng, shape):
    """Random field words in the field's own form (Montgomery words for
    a MontField are any words below p as well)."""
    return rng.integers(0, F.p, size=shape)


@pytest.mark.parametrize("name", FIELDS)
def test_poly_helpers_match_jax(name):
    F, J = _fields(name)
    rng = np.random.default_rng(1)
    a, b = _words(F, rng, 7), _words(F, rng, 5)
    xs = _words(F, rng, 6)
    pts = (0, 1, 5, F.p - 1)
    got = dict(
        padd=P.padd(F, _t(a), _t(b)), psub=P.psub(F, _t(a), _t(b)),
        pneg=P.pneg(F, _t(a)), pscale=P.pscale(F, _t(a), 9),
        padd_const=P.padd_const(F, _t(a), 11), pshift=P.pshift(F, _t(a), 3),
        pmul=P.pmul_school(F, _t(a), _t(b)),
        peval=torch.stack([P.peval(F, _t(a), x) for x in pts]),
        peval_many=P.peval_many(F, _t(a), _t(xs)),
        pow_vector=P.pow_vector(F, _t(7), 9))
    want = jax.jit(lambda a, b, xs: dict(
        padd=JP.padd(J, a, b), psub=JP.psub(J, a, b), pneg=JP.pneg(J, a),
        pscale=JP.pscale(J, a, 9), padd_const=JP.padd_const(J, a, 11),
        pshift=JP.pshift(J, a, 3), pmul=JP.pmul_school(J, a, b),
        peval=jnp.stack([JP.peval(J, a, x) for x in pts]),
        peval_many=JP.peval_many(J, a, xs),
        pow_vector=JP.pow_vector(J, 7, 9)))(_j(a), _j(b), _j(xs))
    for k in got:
        _eq(got[k], want[k])
    for trimmed in ([3, 0, 0], [0], [1, 2, 0, 4, 0], [0, 0, 0]):
        assert P.effective_len(_t(trimmed)) == JP.effective_len(
            np.array(trimmed)) == P.effective_len(trimmed)


@pytest.mark.parametrize("name", FIELDS)
def test_pz_plagrange_match_jax(name):
    F, J = _fields(name)
    rng = np.random.default_rng(2)
    xs = F.array([1, 4, 16, 13], "cpu").numpy() if F.p == 17 else \
        rng.choice(F.p, size=5, replace=False)
    ys = _words(F, rng, len(xs))
    want = jax.jit(lambda xs, ys: (JP.pz(J, xs), JP.plagrange(J, xs, ys)))(
        _j(xs), _j(ys))
    _eq(P.pz(F, _t(xs)), want[0])
    lag = P.plagrange(F, _t(xs), _t(ys))
    _eq(lag, want[1])
    # the interpolating polynomial takes ys at xs
    _eq(P.peval_many(F, lag, _t(xs)), ys)


@pytest.mark.parametrize("name", FIELDS)
def test_divisions_match_jax(name):
    F, J = _fields(name)
    rng = np.random.default_rng(3)
    num, den = _words(F, rng, 9), _words(F, rng, 4)
    den[-1] = den[-1] or 1
    vans = [_words(F, rng, L) for L in (22, 14, 9)]
    ns = (4, 4, 8)
    t = _words(F, rng, 7)
    cs = (1, 3, F.p - 1)
    got = [P.pdivide(F, _t(num), _t(den)),
           P.pdivide(F, _t(den), _t(num))]           # den longer than num
    got += [P.divide_by_vanishing(F, _t(v), n) for v, n in zip(vans, ns)]
    got += [P.divide_by_linear(F, _t(t), _t(c)) for c in cs]
    want = jax.jit(lambda num, den, vans, t: (
        [JP.pdivide(J, num, den), JP.pdivide(J, den, num)]
        + [JP.divide_by_vanishing(J, v, n) for v, n in zip(vans, ns)]
        + [JP.divide_by_linear(J, t, c) for c in cs]))(
        _j(num), _j(den), [_j(v) for v in vans], _j(t))
    for (q, r), (jq, jr) in zip(got, want):
        _eq(q, jq)
        _eq(r, jr)
    with pytest.raises(ValueError):
        P.divide_by_vanishing(F, _t(_words(F, rng, 4)), 4)


@pytest.mark.parametrize("name", FIELDS)
def test_batched_rows_equal_single_rows(name):
    """A leading batch axis (polynomials and per-row scalars) gives each
    row's own result: the form the batched prover relies on."""
    F, _ = _fields(name)
    rng = np.random.default_rng(4)
    B = 5
    a, b = _words(F, rng, (B, 7)), _words(F, rng, (B, 3))
    s = _words(F, rng, B)
    s[0] = 0                       # divide_by_linear at 0 gives q = 0
    q, r = P.divide_by_linear(F, _t(a), _t(s))
    batched = {
        "pmul": P.pmul_school(F, _t(a), _t(b)),
        "peval": P.peval(F, _t(a), _t(s)),
        "padd_const": P.padd_const(F, _t(a), _t(s)),
        "pow_vector": P.pow_vector(F, _t(s), 6),
        "vanish": P.divide_by_vanishing(F, _t(a), 4)[0],
        "linear": torch.cat([q, r[:, None]], dim=-1),
        "pz": P.pz(F, _t(b)),
    }
    for i in range(B):
        q, r = P.divide_by_linear(F, _t(a[i]), _t(s[i]))
        single = {
            "pmul": P.pmul_school(F, _t(a[i]), _t(b[i])),
            "peval": P.peval(F, _t(a[i]), int(s[i])),
            "padd_const": P.padd_const(F, _t(a[i]), int(s[i])),
            "pow_vector": P.pow_vector(F, _t(s[i]), 6),
            "vanish": P.divide_by_vanishing(F, _t(a[i]), 4)[0],
            "linear": torch.cat([q, r[None]]),
            "pz": P.pz(F, _t(b[i])),
        }
        for k, v in single.items():
            _eq(batched[k][i], v)
    # a shared polynomial against per-row scalars broadcasts
    _eq(P.padd_const(F, _t(a[0]), _t(s))[:, 1:],
        np.broadcast_to(a[0, 1:], (B, 6)))


@pytest.mark.parametrize("name", FIELDS)
def test_ntt_helpers_match_jax(name):
    F, J = _fields(name)
    params = getattr(PR, name)
    rng = np.random.default_rng(5)
    n = 4 if params.p == 17 else 16
    w = params.root_of_unity(n)
    vals = _words(F, rng, (3, n))
    short = _words(F, rng, n - 1)
    a, b = _words(F, rng, 3), _words(F, rng, 4)
    if params.p == 17:
        a, b = a[:2], b[:3]                    # F17 domains stop at 16
    want = jax.jit(lambda vals, short, a, b: (
        JN.interpolate(J, vals, w), JN.evaluate_on_domain(J, short, w, n),
        JN.ntt_mul(J, a, b)))(_j(vals), _j(short), _j(a), _j(b))
    coeffs = N.interpolate(F, _t(vals), w)
    _eq(coeffs, want[0])
    _eq(N.evaluate_on_domain(F, coeffs, w, n), vals)
    _eq(N.evaluate_on_domain(F, _t(short), w, n), want[1])
    got = N.ntt_mul(F, _t(a), _t(b))
    _eq(got, want[2])
    _eq(got, P.pmul_school(F, _t(a), _t(b)))


@pytest.mark.parametrize("name", FIELDS)
def test_matrix_matches_jax(name):
    F, J = _fields(name)
    p = F.p
    rng = np.random.default_rng(6)
    a, b = _words(F, rng, (3, 4)), _words(F, rng, (4, 2))
    _eq(MX.mat_add(F, _t(a), _t(a[::-1].copy())),
        JMX.mat_add(J, _j(a), _j(a[::-1].copy())))
    _eq(MX.mat_mul(F, _t(a), _t(b)), JMX.mat_mul(J, _j(a), _j(b)))
    pts = rng.choice(p, size=4, replace=False)
    v = MX.vandermonde_host(p, pts)
    _eq(v, JMX.vandermonde_host(p, pts))
    inv = MX.mat_inv_host(p, v)
    _eq(inv, JMX.mat_inv_host(p, v))
    _eq(v.astype(object) @ inv.astype(object) % p, np.eye(4))
    sing = np.array([[1, 2, 3], [2, 4, 6], [0, 0, 5]])
    _eq(MX.gauss_jordan_host(p, sing), JMX.gauss_jordan_host(p, sing))
    with pytest.raises(ValueError):
        MX.mat_inv_host(p, np.zeros((2, 3)))


def test_intt_is_inverse_vandermonde_and_golden():
    """INTT over H = {1, 4, 16, 13} equals h_pows_inv @ values, and
    h_pows_inv equals the reference's (src/plonk-test.c:38)."""
    F = FM.Field(PR.HF17)
    h = GOLDEN["h"]
    inv = MX.mat_inv_host(17, MX.vandermonde_host(17, h))
    _eq(inv, GOLDEN["h_pows_inv"])
    cols = N.interpolate(F, torch.eye(4, dtype=torch.int64), 4)
    _eq(cols.T, inv)
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 17, size=4)
    _eq(N.interpolate(F, _t(vals), 4), inv @ vals % 17)
    _eq(MX.mat_mul(F, _t(inv), _t(vals[:, None]))[:, 0], inv @ vals % 17)
