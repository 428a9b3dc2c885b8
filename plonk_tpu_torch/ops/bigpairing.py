"""BN254 G2 and the optimal-ate pairing over the Fq12 tower (`ops/tower.py`).

Port of the math of `plonk_tpu/ops/bigpairing.py`:
- G2 points are Jacobian over Fq2, each coordinate an Fq2 tensor
  (..., 2, limbs); Z == 0 is infinity; additions are complete by masks.
- The Miller loop walks the bits of 6x + 2 in Python, doing the addition
  step only where the bit is set (the JAX scan computes it on every step
  and selects). Line denominators are kept: they lie in Fq2, which the
  final exponentiation's easy part annihilates.
- `final_exponentiation` is the easy part and the BN hard-part addition
  chain (the JAX package runs that chain as a scanned tape to bound
  XLA:CPU compile time; here it is written out). The tests hold it
  against the oracle's plain (p^12 - 1)/r power.
Everything is elementwise over a batch prefix: a batch of pairings is one
Miller loop with wider tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bigcurve import BN254_FQ, host_bit_length
from .bigfield import BigMontField
from .tower import (f2_conj, f2_const, f2_inv, f2_is_zero, f2_mul,
                    f2_mul_fq, f2_one, f2_zero, f12_conj, f12_frobenius,
                    f12_inv, f12_mul, f12_one, f12_sq, gamma_rows)

X_PARAM = 4965661367192848881
ATE_LOOP = 6 * X_PARAM + 2

G2_GEN_X = (10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634)
G2_GEN_Y = (8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531)


def pairing_field() -> BigMontField:
    """The Fq instance the pairing runs on."""
    return BigMontField(BN254_FQ)


class G2J(NamedTuple):
    """Jacobian G2 batch: each coordinate an Fq2 tensor (..., 2, limbs)."""
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor

    @staticmethod
    def identity(F, shape, device) -> "G2J":
        one = f2_one(F, shape, device)
        return G2J(one, one, f2_zero(F, shape, device))


def _sel2(mask, a, b):
    return torch.where(mask[..., None, None], a, b)


def _sel_g2(mask, p: G2J, q: G2J) -> G2J:
    return G2J(*(_sel2(mask, a, b) for a, b in zip(p, q)))


def _mul_many(F, pairs):
    """Independent Fq2 products in one call."""
    shape = torch.broadcast_shapes(*[t.shape for pr in pairs for t in pr])
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return list(f2_mul(F, a, b).unbind(0))


def _dbl(F, a):
    return F.add(a, a)


def g2_generator(F, shape, device) -> G2J:
    gx = f2_const(F, G2_GEN_X, device).expand(tuple(shape) + (2, F.limbs))
    gy = f2_const(F, G2_GEN_Y, device).expand(tuple(shape) + (2, F.limbs))
    return G2J(gx, gy, f2_one(F, shape, device))


def g2_double(F, p: G2J) -> G2J:
    """dbl-2009-l over Fq2 (a = 0)."""
    A, B, YZ = _mul_many(F, [(p.X, p.X), (p.Y, p.Y), (p.Y, p.Z)])
    E = F.add(_dbl(F, A), A)
    XB = F.add(p.X, B)
    C, t, Fv = _mul_many(F, [(B, B), (XB, XB), (E, E)])
    D = _dbl(F, F.sub(t, F.add(A, C)))
    X3 = F.sub(Fv, _dbl(F, D))
    C8 = _dbl(F, _dbl(F, _dbl(F, C)))
    Y3 = F.sub(f2_mul(F, E, F.sub(D, X3)), C8)
    return G2J(X3, Y3, _dbl(F, YZ))


def g2_add(F, p: G2J, q: G2J) -> G2J:
    """Complete Jacobian addition with masked identity, doubling and
    inverse cases."""
    Z1Z1, Z2Z2, Z12 = _mul_many(F, [(p.Z, p.Z), (q.Z, q.Z), (p.Z, q.Z)])
    U1, U2, Z2c, Z1c = _mul_many(F, [(p.X, Z2Z2), (q.X, Z1Z1),
                                     (q.Z, Z2Z2), (p.Z, Z1Z1)])
    S1, S2 = _mul_many(F, [(p.Y, Z2c), (q.Y, Z1c)])
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    HH, rr, Z3 = _mul_many(F, [(H, H), (r, r), (Z12, H)])
    HHH, V = _mul_many(F, [(H, HH), (U1, HH)])
    X3 = F.sub(F.sub(rr, HHH), _dbl(F, V))
    rV, SH = _mul_many(F, [(r, F.sub(V, X3)), (S1, HHH)])
    gen = G2J(X3, F.sub(rV, SH), Z3)
    dbl = g2_double(F, p)
    p_inf, q_inf = f2_is_zero(F, p.Z), f2_is_zero(F, q.Z)
    same_x = f2_is_zero(F, H) & ~p_inf & ~q_inf
    r_zero = f2_is_zero(F, r)
    out = _sel_g2(same_x & r_zero, dbl, gen)
    out = G2J(out.X, out.Y,
              _sel2(same_x & ~r_zero, torch.zeros_like(out.Z), out.Z))
    out = _sel_g2(p_inf, q, out)
    return _sel_g2(q_inf, p, out)


def g2_mul_bits(F, base: G2J, scalar_bits, nbits: int) -> G2J:
    """Masked double-and-add ladder; scalar_bits (..., nbits) LSB first.
    Host bits (numpy) skip the addition where no lane has the bit set, and
    the steps above the highest set bit."""
    host = None if isinstance(scalar_bits, torch.Tensor) else \
        np.asarray(scalar_bits)
    if host is not None:
        nbits = host_bit_length(host, nbits)
    bits = torch.as_tensor(scalar_bits, device=base.X.device)
    acc = G2J.identity(F, base.X.shape[:-2], base.X.device)
    cur = base
    for i in range(nbits):
        if host is None or host[..., i].any():
            acc = _sel_g2(bits[..., i] == 1, g2_add(F, acc, cur), acc)
        if i + 1 < nbits:
            cur = g2_double(F, cur)
    return acc


def g2_to_affine(F, p: G2J):
    """-> (x, y, inf), Montgomery Fq2 affine coordinates."""
    zinv = f2_inv(F, p.Z)
    zi2 = f2_mul(F, zinv, zinv)
    x, zi3 = _mul_many(F, [(p.X, zi2), (zi2, zinv)])
    y = f2_mul(F, p.Y, zi3)
    inf = f2_is_zero(F, p.Z)
    return (_sel2(inf, torch.zeros_like(x), x),
            _sel2(inf, torch.zeros_like(y), y), inf)


def _twist_b(F, device) -> torch.Tensor:
    """b' = 3 / (9 + u), the D-twist curve constant."""
    p = BN254_FQ.p
    ni = pow(82, p - 2, p)
    return f2_const(F, (27 * ni % p, (-3) * ni % p), device)


def g2_on_curve(F, x, y):
    """y^2 == x^3 + b' (Montgomery affine twist coordinates)."""
    rhs = F.add(f2_mul(F, f2_mul(F, x, x), x), _twist_b(F, x.device))
    return (f2_mul(F, y, y) == rhs).flatten(-2).all(-1)


# ---------------- Miller loop ----------------

def _dbl_step(F, T: G2J):
    """T <- 2T and the tangent line at T as (cy, cx, c3): the line is
    cy*yp + cx*xp w + c3 w^3 (denominator 2 Y Z^3 kept)."""
    A, B, YZ, Zsq = _mul_many(F, [(T.X, T.X), (T.Y, T.Y), (T.Y, T.Z),
                                  (T.Z, T.Z)])
    E = F.add(_dbl(F, A), A)
    Z3 = _dbl(F, YZ)
    XB = F.add(T.X, B)
    C, t, Fv, cy, EZ, EX = _mul_many(F, [(B, B), (XB, XB), (E, E),
                                         (Z3, Zsq), (E, Zsq), (E, T.X)])
    D = _dbl(F, F.sub(t, F.add(A, C)))
    X3 = F.sub(Fv, _dbl(F, D))
    C8 = _dbl(F, _dbl(F, _dbl(F, C)))
    Y3 = F.sub(f2_mul(F, E, F.sub(D, X3)), C8)
    return G2J(X3, Y3, Z3), (cy, F.neg(EZ), F.sub(EX, _dbl(F, B)))


def _add_step(F, T: G2J, qx, qy):
    """T <- T + Q (Q affine) and the chord line through T and Q
    (denominator (xq Z^2 - X) Z kept)."""
    Zsq = f2_mul(F, T.Z, T.Z)
    Zcu, xZ2 = _mul_many(F, [(T.Z, Zsq), (qx, Zsq)])
    yZ3 = f2_mul(F, qy, Zcu)
    theta = F.sub(yZ3, T.Y)
    eta = F.sub(xZ2, T.X)
    HH, rr, Z3 = _mul_many(F, [(eta, eta), (theta, theta), (T.Z, eta)])
    HHH, V = _mul_many(F, [(eta, HH), (T.X, HH)])
    X3 = F.sub(F.sub(rr, HHH), _dbl(F, V))
    tVX, YH, txq, Zyq = _mul_many(F, [(theta, F.sub(V, X3)), (T.Y, HHH),
                                      (theta, qx), (Z3, qy)])
    return (G2J(X3, F.sub(tVX, YH), Z3),
            (Z3, F.neg(theta), F.sub(txq, Zyq)))


def _line_mul(F, f, line, px, py):
    """f * (cy*yp + cx*xp w + c3 w^3): the line as an Fq12 whose only
    nonzero coefficients are [0][0] (w^0), [1][0] (w^1) and [1][1]
    (w^3)."""
    cy, cx, c3 = line
    l0, l1 = f2_mul_fq(F, torch.stack([cy, cx]),
                       torch.stack([py, px])).unbind(0)
    z = torch.zeros_like(l0)
    ln = torch.stack([torch.stack([l0, z, z], -3),
                      torch.stack([l1, c3, z], -3)], -4)
    return f12_mul(F, f, ln)


def _frobenius_g2(F, qx, qy, power: int):
    """pi_p(x, y) = (conj(x) g1[2], conj(y) g1[3]);
    pi_p^2(x, y) = (x g2[2], -y g2[3]) on affine twist coordinates."""
    gam = gamma_rows(F, power, qx.device)       # [i][j]: w-degree i + 2j
    g2w, g3w = gam[0, 1], gam[1, 1]             # degrees 2 and 3
    if power == 1:
        return (f2_mul(F, f2_conj(F, qx), g2w), f2_mul(F, f2_conj(F, qy),
                                                      g3w))
    return f2_mul(F, qx, g2w), F.neg(f2_mul(F, qy, g3w))


def miller_loop(F, px, py, qx, qy):
    """f_{6x+2, Q}(P) with the two Frobenius correction lines. px, py:
    Montgomery base-field coordinates (..., limbs); qx, qy: Montgomery
    affine twist coordinates (..., 2, limbs)."""
    shape = px.shape[:-1]
    T = G2J(qx, qy, f2_one(F, shape, px.device))
    f = f12_one(F, shape, px.device)
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_sq(F, f)
        T, ln = _dbl_step(F, T)
        f = _line_mul(F, f, ln, px, py)
        if bit == "1":
            T, ln = _add_step(F, T, qx, qy)
            f = _line_mul(F, f, ln, px, py)
    q1x, q1y = _frobenius_g2(F, qx, qy, 1)
    q2x, q2y = _frobenius_g2(F, qx, qy, 2)
    T, ln = _add_step(F, T, q1x, q1y)
    f = _line_mul(F, f, ln, px, py)
    _, ln = _add_step(F, T, q2x, q2y)
    return _line_mul(F, f, ln, px, py)


# ---------------- final exponentiation ----------------

def _easy_part(F, f):
    """f^((p^6 - 1)(p^2 + 1))."""
    t = f12_mul(F, f12_conj(F, f), f12_inv(F, f))
    return f12_mul(F, f12_frobenius(F, t, 2), t)


def _pow(F, a, e: int):
    """a^e (e >= 1), MSB-first square-and-multiply."""
    acc = a
    for bit in bin(e)[3:]:
        acc = f12_sq(F, acc)
        if bit == "1":
            acc = f12_mul(F, acc, a)
    return acc


def final_exponentiation(F, f):
    """Easy part and the BN hard-part addition chain (Devegili et al. /
    Scott et al.): exactly m^((p^4 - p^2 + 1)/r)."""
    m = _easy_part(F, f)
    fx = _pow(F, m, X_PARAM)
    fx2 = _pow(F, fx, X_PARAM)
    fx3 = _pow(F, fx2, X_PARAM)
    fr = lambda a, k: f12_frobenius(F, a, k)
    y0 = f12_mul(F, f12_mul(F, fr(m, 1), fr(m, 2)), fr(m, 3))
    y1 = f12_conj(F, m)
    y2 = fr(fx2, 2)
    y3 = f12_conj(F, fr(fx, 1))
    y4 = f12_conj(F, f12_mul(F, fx, fr(fx2, 1)))
    y5 = f12_conj(F, fx2)
    y6 = f12_conj(F, f12_mul(F, fx3, fr(fx3, 1)))
    t0 = f12_mul(F, f12_mul(F, f12_sq(F, y6), y4), y5)
    t1 = f12_mul(F, f12_mul(F, y3, y5), t0)
    t0 = f12_mul(F, t0, y2)
    t1 = f12_sq(F, f12_mul(F, f12_sq(F, t1), t0))
    t0 = f12_sq(F, f12_mul(F, t1, y1))
    return f12_mul(F, t0, f12_mul(F, t1, y0))


def pairing(F, p, qx, qy):
    """e(P, Q) for a Jacobian G1 batch P (ops/bigcurve.BigG1J) and affine
    twist coordinates Q; P at infinity maps to 1."""
    from .bigcurve import big_to_affine
    px, py, pinf = big_to_affine(F, p)
    f = miller_loop(F, px, py, qx, qy)
    out = final_exponentiation(F, f)
    return torch.where(pinf[..., None, None, None, None],
                       f12_one(F, pinf.shape, px.device), out)
