"""Batched elliptic-curve group ops: G1, G2 (quadratic twist), GT, and
Jacobian G1.

Port of `plonk_tpu/ops/curve.py` with the same semantics:
- points are structs of int64 coordinate tensors (any batch shape, Montgomery
  form); the point at infinity is a bool mask;
- add/double are branchless: every candidate is computed on all lanes and
  selected with masks, in the reference's dispatch order (infinity, then
  x1 == x2 with y1 + y2 == 0 -> infinity, x1 == x2 otherwise -> double);
- g1_double returns infinity when y == 0;
- G2 has no infinity encoding and keeps the d vs 1/d asymmetry between its
  double and add branches; g2_mul(base, 0) returns the (0, 0) struct;
- GT = F_p[u]/(u^2 - d); gt_pow_static keeps the Frobenius recursion;
- jac_add is complete: identity, equal points (double) and inverse points
  (infinity) are all handled.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I64 = torch.int64


class G1(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool

    @staticmethod
    def of(F, x: int, y: int, device) -> "G1":
        return G1(torch.tensor(F.const(x), dtype=I64, device=device),
                  torch.tensor(F.const(y), dtype=I64, device=device),
                  torch.tensor(False, device=device))

    @staticmethod
    def identity(shape, device) -> "G1":
        return G1(torch.zeros(shape, dtype=I64, device=device),
                  torch.zeros(shape, dtype=I64, device=device),
                  torch.ones(shape, dtype=torch.bool, device=device))


class G2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor

    @staticmethod
    def of(F, x: int, y: int, device) -> "G2":
        return G2(torch.tensor(F.const(x), dtype=I64, device=device),
                  torch.tensor(F.const(y), dtype=I64, device=device))


class GT(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor

    @staticmethod
    def one(F, shape, device) -> "GT":
        return GT(F.ones(shape, device),
                  torch.zeros(shape, dtype=I64, device=device))


def _sel(mask, a, b):
    return torch.where(mask, a, b)


def _sel_g1(mask, a: G1, b: G1) -> G1:
    return G1(_sel(mask, a.x, b.x), _sel(mask, a.y, b.y),
              _sel(mask, a.inf, b.inf))


# ---------------- G1 ----------------

def g1_generator(curve, F, device) -> G1:
    return G1.of(F, *curve.g1_gen, device)


def g1_is_on_curve(F, b_const: int, p: G1) -> torch.Tensor:
    """y^2 == x^3 + b; infinity counts as on-curve."""
    lhs = F.mul(p.y, p.y)
    rhs = F.add(F.mul(F.mul(p.x, p.x), p.x), F.const(b_const))
    return torch.logical_or(p.inf, lhs == rhs)


def g1_neg(F, p: G1) -> G1:
    return G1(p.x, F.neg(p.y), p.inf)


def g1_double(F, a: G1) -> G1:
    """Tangent doubling with y == 0 -> infinity."""
    two, three = F.const(2), F.const(3)
    m = F.div(F.mul(F.mul(a.x, a.x), three), F.mul(a.y, two))
    m_sq = F.mul(m, m)
    x_r = F.sub(m_sq, F.mul(a.x, two))
    y_r = F.sub(F.mul(m, F.sub(F.mul(a.x, three), m_sq)), a.y)
    is_inf = torch.logical_or(a.inf, a.y == 0)
    return G1(_sel(is_inf, torch.zeros_like(x_r), x_r),
              _sel(is_inf, torch.zeros_like(y_r), y_r),
              is_inf)


def g1_add(F, a: G1, b: G1) -> G1:
    """Addition with the reference's dispatch order, branchless."""
    m = F.div(F.sub(b.y, a.y), F.sub(b.x, a.x))
    m_sq = F.mul(m, m)
    x_r = F.sub(F.sub(m_sq, a.x), b.x)
    y_r = F.sub(F.mul(m, F.sub(a.x, x_r)), a.y)
    chord = G1(x_r, y_r, torch.zeros_like(x_r, dtype=torch.bool))

    dbl = g1_double(F, a)

    same_x = a.x == b.x
    inverse = torch.logical_and(same_x, F.add(a.y, b.y) == 0)
    both_fin = torch.logical_and(~a.inf, ~b.inf)

    ident = G1.identity(x_r.shape, x_r.device)
    r = _sel_g1(same_x, _sel_g1(inverse, ident, dbl), chord)
    return _sel_g1(both_fin, r, _sel_g1(a.inf, b, a))


def g1_mul(F, p: G1, scalar, nbits: int = 32) -> G1:
    """Masked double-and-add over `nbits` bits, LSB first. `scalar` holds
    standard-form non-negative integers < 2^32 (tensor or Python int)."""
    sc = torch.as_tensor(scalar, dtype=I64, device=p.x.device)
    shape = torch.broadcast_shapes(p.x.shape, sc.shape)
    acc = G1.identity(shape, p.x.device)
    added = G1(p.x.expand(shape), p.y.expand(shape),
               p.inf.expand(shape))
    sc = sc.expand(shape)
    for _ in range(nbits):
        bit = (sc & 1) == 1
        acc = _sel_g1(bit, g1_add(F, acc, added), acc)
        added = g1_double(F, added)
        sc = sc >> 1
    return acc


def g1_equal(a: G1, b: G1) -> torch.Tensor:
    both_inf = torch.logical_and(a.inf, b.inf)
    coords = torch.logical_and(a.x == b.x, a.y == b.y)
    fin = torch.logical_and(torch.logical_and(~a.inf, ~b.inf), coords)
    return torch.logical_or(both_inf, fin)


# ---------------- G2 (points on the quadratic twist by d) ----------------

def g2_generator(curve, F, device) -> G2:
    return G2.of(F, *curve.g2_gen, device)


def g2_neg(F, p: G2) -> G2:
    return G2(p.x, F.neg(p.y))


def g2_add(F, d_const: int, p: G2, q: G2) -> G2:
    """Reference formula structure with the twist constant d = u^2."""
    two, three = F.const(2), F.const(3)
    d = F.const(d_const % F.p)

    # doubling branch (p == q): slope scaled by 1/d
    m_dbl = F.div(F.mul(F.mul(p.x, p.x), three), F.mul(p.y, two))
    d_inv = F.const(pow(d_const % F.p, -1, F.p))
    msq_d = F.mul(F.mul(m_dbl, m_dbl), d_inv)
    x_dbl = F.sub(msq_d, F.mul(p.x, two))
    y_dbl = F.sub(F.mul(F.mul(m_dbl, d_inv),
                        F.sub(F.mul(p.x, three), msq_d)), p.y)

    # chord branch: slope-squared scaled by d
    m_add = F.div(F.sub(q.y, p.y), F.sub(q.x, p.x))
    msq_d2 = F.mul(F.mul(m_add, m_add), d)
    x_add = F.sub(F.sub(msq_d2, p.x), q.x)
    y_add = F.sub(F.mul(m_add, F.sub(p.x, x_add)), p.y)

    same = torch.logical_and(p.x == q.x, p.y == q.y)
    return G2(_sel(same, x_dbl, x_add), _sel(same, y_dbl, y_add))


def g2_mul(F, d_const: int, base: G2, scalar, nbits: int = 32) -> G2:
    """Flag-style ladder: the accumulator starts as the first set-bit
    multiple of base (G2 has no identity encoding); scalar 0 -> (0, 0)."""
    sc = torch.as_tensor(scalar, dtype=I64, device=base.x.device)
    shape = torch.broadcast_shapes(base.x.shape, sc.shape)
    dev = base.x.device
    res = G2(torch.zeros(shape, dtype=I64, device=dev),
             torch.zeros(shape, dtype=I64, device=dev))
    cur = G2(base.x.expand(shape), base.y.expand(shape))
    flag = torch.zeros(shape, dtype=torch.bool, device=dev)
    sc = sc.expand(shape)
    for _ in range(nbits):
        bit = (sc & 1) == 1
        summed = g2_add(F, d_const, res, cur)
        new_x = _sel(bit, _sel(flag, summed.x, cur.x), res.x)
        new_y = _sel(bit, _sel(flag, summed.y, cur.y), res.y)
        flag = torch.logical_or(flag, bit)
        res = G2(new_x, new_y)
        cur = g2_add(F, d_const, cur, cur)
        sc = sc >> 1
    return res


# ---------------- GT = F_p[u] / (u^2 - d) ----------------

def gt_mul(F, d_const: int, x: GT, y: GT) -> GT:
    """(a1 + b1 u)(a2 + b2 u) with u^2 = d."""
    d = F.const(d_const % F.p)
    a = F.add(F.mul(x.a, y.a), F.mul(F.mul(x.b, d), y.b))
    b = F.add(F.mul(x.a, y.b), F.mul(x.b, y.a))
    return GT(a, b)


def gt_conj(F, x: GT) -> GT:
    """Conjugation a - bu == Frobenius x^p."""
    return GT(x.a, F.neg(x.b))


def gt_pow_static(F, d_const: int, x: GT, e: int) -> GT:
    """x^e for a static exponent, with the reference's Frobenius recursion
    for e >= p: x^e = conj(x^(e // p)) * x^(e % p)."""
    if e >= F.p:
        acc = gt_conj(F, gt_pow_static(F, d_const, x, e // F.p))
        e = e % F.p
    else:
        acc = GT.one(F, x.a.shape, x.a.device)
    cur = x
    while e > 0:
        if e & 1:
            acc = gt_mul(F, d_const, acc, cur)
        e >>= 1
        if e:
            cur = gt_mul(F, d_const, cur, cur)
    return acc


def gt_pow(F, d_const: int, x: GT, e, nbits: int = 32) -> GT:
    """x^e for tensor exponents (elementwise masked square-and-multiply)."""
    ee = torch.as_tensor(e, dtype=I64, device=x.a.device)
    shape = torch.broadcast_shapes(x.a.shape, ee.shape)
    acc = GT.one(F, shape, x.a.device)
    cur = GT(x.a.expand(shape), x.b.expand(shape))
    ee = ee.expand(shape)
    for _ in range(nbits):
        bit = (ee & 1) == 1
        mul = gt_mul(F, d_const, acc, cur)
        acc = GT(_sel(bit, mul.a, acc.a), _sel(bit, mul.b, acc.b))
        cur = gt_mul(F, d_const, cur, cur)
        ee = ee >> 1
    return acc


def gt_equal(x: GT, y: GT) -> torch.Tensor:
    return torch.logical_and(x.a == y.a, x.b == y.b)


def gt_inv(F, d_const: int, x: GT) -> GT:
    """(a + bu)^{-1} = (a - bu) / (a^2 - d*b^2)."""
    d = F.const(d_const % F.p)
    norm = F.sub(F.mul(x.a, x.a), F.mul(F.mul(x.b, d), x.b))
    ninv = F.inv(norm)
    return GT(F.mul(x.a, ninv), F.mul(F.neg(x.b), ninv))


# ---------------- Jacobian coordinates ----------------

class G1J(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor  # Z == 0 encodes the point at infinity

    @staticmethod
    def identity(F, shape, device) -> "G1J":
        return G1J(F.ones(shape, device), F.ones(shape, device),
                   torch.zeros(shape, dtype=I64, device=device))


def jac_from_affine(F, p: G1) -> G1J:
    one = F.ones(p.x.shape, p.x.device)
    z = torch.where(p.inf, torch.zeros_like(one), one)
    return G1J(torch.where(p.inf, one, p.x), torch.where(p.inf, one, p.y), z)


def jac_to_affine(F, p: G1J) -> G1:
    zinv = F.inv(p.Z)                     # inv(0) = 0 -> garbage, masked
    zi2 = F.mul(zinv, zinv)
    x = F.mul(p.X, zi2)
    y = F.mul(p.Y, F.mul(zi2, zinv))
    inf = p.Z == 0
    return G1(torch.where(inf, torch.zeros_like(x), x),
              torch.where(inf, torch.zeros_like(y), y), inf)


def jac_double(F, p: G1J) -> G1J:
    """2P for a = 0 curves (y^2 = x^3 + b). Z = 0 and Y = 0 map to
    infinity."""
    A = F.mul(p.X, p.X)
    B = F.mul(p.Y, p.Y)
    Cc = F.mul(B, B)
    t = F.add(p.X, B)
    D = F.mul(F.sub(F.sub(F.mul(t, t), A), Cc), F.const(2))
    E = F.mul(A, F.const(3))
    Ff = F.mul(E, E)
    X3 = F.sub(Ff, F.mul(D, F.const(2)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.mul(Cc, F.const(8)))
    Z3 = F.mul(F.mul(p.Y, p.Z), F.const(2))
    return G1J(X3, Y3, Z3)


def jac_add(F, p: G1J, q: G1J) -> G1J:
    """Complete Jacobian addition: identity, equal and inverse points
    handled with masked selects (branchless)."""
    Z1Z1 = F.mul(p.Z, p.Z)
    Z2Z2 = F.mul(q.Z, q.Z)
    U1 = F.mul(p.X, Z2Z2)
    U2 = F.mul(q.X, Z1Z1)
    S1 = F.mul(p.Y, F.mul(q.Z, Z2Z2))
    S2 = F.mul(q.Y, F.mul(p.Z, Z1Z1))
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)

    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    rr = F.mul(r, r)
    X3 = F.sub(F.sub(rr, HHH), F.mul(V, F.const(2)))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(p.Z, q.Z), H)

    dbl = jac_double(F, p)

    p_inf = p.Z == 0
    q_inf = q.Z == 0
    same_x = torch.logical_and(H == 0, torch.logical_and(~p_inf, ~q_inf))
    same_pt = torch.logical_and(same_x, r == 0)
    inverse = torch.logical_and(same_x, r != 0)

    X3 = _sel(same_pt, dbl.X, X3)
    Y3 = _sel(same_pt, dbl.Y, Y3)
    Z3 = _sel(same_pt, dbl.Z, Z3)
    Z3 = _sel(inverse, torch.zeros_like(Z3), Z3)
    X3 = _sel(p_inf, q.X, X3)
    Y3 = _sel(p_inf, q.Y, Y3)
    Z3 = _sel(p_inf, q.Z, Z3)
    X3 = _sel(q_inf, p.X, X3)
    Y3 = _sel(q_inf, p.Y, Y3)
    Z3 = _sel(q_inf, p.Z, Z3)
    return G1J(X3, Y3, Z3)
