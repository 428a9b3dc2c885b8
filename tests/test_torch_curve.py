"""Parity of the port's curve ops (plonk_tpu_torch.ops.curve) with the JAX
package's on the scaled curve: affine G1 with its dispatch order, G2 with
its scalar-0 convention, GT, and the complete Jacobian addition. Exact
equality of words."""
import numpy as np
import jax.numpy as jnp
import torch

from plonk_tpu.ops import curve as JC
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import SCALED_CURVE, SCALED_FQ
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops.field import MontField

Fq, Jq = MontField(SCALED_FQ), JMontField(SCALED_FQ)
R = SCALED_CURVE.r
D = SCALED_CURVE.d
# scalars 0, 1, equal and opposite multiples, random
KS = np.array([0, 1, 5, 5, R - 5, 77, 123456, R - 1], dtype=np.int64)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.as_tensor(a if a.dtype == bool else a.astype(np.int64))


def _eq(got, want) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def _points():
    """The same G1 multiples on both sides (port computes, JAX copies)."""
    g = C.g1_generator(SCALED_CURVE, Fq, "cpu")
    pts = C.g1_mul(Fq, g, torch.as_tensor(KS), nbits=R.bit_length())
    jg = JC.g1_generator(SCALED_CURVE, Jq)
    want = JC.g1_mul(Jq, jg, jnp.asarray(KS.astype(np.uint32)),
                     nbits=R.bit_length())
    _eq(pts, want)
    return pts, JC.G1(*(jnp.asarray(np.array(a)) for a in want))


def test_g1_ops_match_jax():
    pts, jpts = _points()
    # pair every point with a rotated copy: infinity, equal, opposite and
    # generic operands all occur
    rot = C.G1(*(torch.roll(a, 1) for a in pts))
    jrot = JC.G1(*(jnp.roll(a, 1) for a in jpts))
    _eq(C.g1_add(Fq, pts, rot), JC.g1_add(Jq, jpts, jrot))
    _eq(C.g1_add(Fq, pts, pts), JC.g1_add(Jq, jpts, jpts))
    _eq(C.g1_double(Fq, pts), JC.g1_double(Jq, jpts))
    _eq(C.g1_neg(Fq, pts), JC.g1_neg(Jq, jpts))
    _eq([C.g1_is_on_curve(Fq, SCALED_CURVE.b, pts)],
        [JC.g1_is_on_curve(Jq, SCALED_CURVE.b, jpts)])
    _eq([C.g1_equal(pts, rot)], [JC.g1_equal(jpts, jrot)])


def test_jacobian_ops_match_jax():
    pts, jpts = _points()
    jac, jjac = C.jac_from_affine(Fq, pts), JC.jac_from_affine(Jq, jpts)
    _eq(jac, jjac)
    rot = C.G1J(*(torch.roll(a, 1) for a in jac))
    jrot = JC.G1J(*(jnp.roll(a, 1) for a in jjac))
    _eq(C.jac_add(Fq, jac, rot), JC.jac_add(Jq, jjac, jrot))
    _eq(C.jac_add(Fq, jac, jac), JC.jac_add(Jq, jjac, jjac))
    _eq(C.jac_double(Fq, jac), JC.jac_double(Jq, jjac))
    _eq(C.jac_to_affine(Fq, C.jac_add(Fq, jac, rot)),
        JC.jac_to_affine(Jq, JC.jac_add(Jq, jjac, jrot)))


def test_g2_and_gt_ops_match_jax():
    g2 = C.g2_generator(SCALED_CURVE, Fq, "cpu")
    jg2 = JC.g2_generator(SCALED_CURVE, Jq)
    ks = np.array([0, 1, 2, 97, 123456789 % R], dtype=np.int64)
    q = C.g2_mul(Fq, D, g2, torch.as_tensor(ks), nbits=R.bit_length())
    jq = JC.g2_mul(Jq, D, jg2, jnp.asarray(ks.astype(np.uint32)),
                   nbits=R.bit_length())
    _eq(q, jq)
    assert int(q.x[0]) == 0 and int(q.y[0]) == 0        # g2_mul(_, 0)
    _eq(C.g2_add(Fq, D, q, C.G2(*(torch.roll(a, 1) for a in q))),
        JC.g2_add(Jq, D, jq, JC.G2(*(jnp.roll(a, 1) for a in jq))))
    _eq(C.g2_neg(Fq, q), JC.g2_neg(Jq, jq))
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, Fq.p, size=6) for _ in range(2))
    x, jx = C.GT(_t(a), _t(b)), JC.GT(jnp.asarray(a.astype(np.uint32)),
                                      jnp.asarray(b.astype(np.uint32)))
    y, jy = C.GT(_t(b), _t(a)), JC.GT(jx.b, jx.a)
    _eq(C.gt_mul(Fq, D, x, y), JC.gt_mul(Jq, D, jx, jy))
    _eq(C.gt_conj(Fq, x), JC.gt_conj(Jq, jx))
    _eq(C.gt_inv(Fq, D, x), JC.gt_inv(Jq, D, jx))
    e = Fq.p + 12345                      # takes the Frobenius recursion
    _eq(C.gt_pow_static(Fq, D, x, e), JC.gt_pow_static(Jq, D, jx, e))
    es = np.array([0, 1, 2, 3, 1000, 2 ** 31 - 1], dtype=np.int64)
    _eq(C.gt_pow(Fq, D, x, torch.as_tensor(es)),
        JC.gt_pow(Jq, D, jx, jnp.asarray(es.astype(np.uint32))))
    _eq([C.gt_equal(x, x)], [JC.gt_equal(jx, jx)])
