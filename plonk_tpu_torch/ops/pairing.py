"""Miller-loop pairing on the scaled curve.

Port of `plonk_tpu/ops/pairing.py`. The reference recursion
r -> (r-1 | r/2) -> ... -> 1 is replayed bottom-up as a schedule of double
and add steps, with the running multiple of P carried from step to step.
Here the schedule is a plain Python loop that computes only the step it
needs; the JAX package computes both branches inside a scan and selects,
which gives the same field values.

Final exponentiation: (p^k - 1)/r with the Frobenius split
x^e = conj(x^(e // p)) * x^(e % p) for e >= p. e(infinity, Q) = 1.
"""
from __future__ import annotations

import numpy as np
import torch

from .curve import (G1, G2, GT, g1_add, g1_double, g1_neg, gt_mul, gt_conj,
                    _sel)


def _line(F, a: G1, b: G1):
    """Line through two (distinct-x) G1 points as (lx, ly, c)."""
    m = F.sub(b.x, a.x)
    n = F.sub(b.y, a.y)
    return n, F.neg(m), F.sub(F.mul(m, a.y), F.mul(n, a.x))


def _gt_term(F, q: G2, lx, ly, c) -> GT:
    """Evaluate the line at the twisted point Q: (qx*lx + c) + (qy*ly) u."""
    return GT(F.add(F.mul(q.x, lx), c), F.mul(q.y, ly))


def _miller_schedule(r: int) -> np.ndarray:
    """Per-step flags of the reference recursion, bottom-up
    (1 = double step, 0 = add step)."""
    steps = []
    while r > 1:
        if r % 2 == 1:
            steps.append(0)
            r -= 1
        else:
            steps.append(1)
            r //= 2
    return np.array(list(reversed(steps)), dtype=np.int32)


def miller_loop(F, curve, p: G1, q: G2, r: int | None = None) -> GT:
    """pairing_f(r, P, Q), batched over any leading point dims."""
    r = curve.r if r is None else r
    d = curve.d
    shape = torch.broadcast_shapes(p.x.shape, q.x.shape)
    f = GT.one(F, shape, p.x.device)
    base = G1(p.x.expand(shape), p.y.expand(shape),
              p.inf.expand(shape))
    qb = G2(q.x.expand(shape), q.y.expand(shape))
    cur = base
    for is_dbl in _miller_schedule(r):
        if is_dbl:
            # f <- f^2 * line(T, -2T)(Q); T <- 2T
            two_neg_t = g1_double(F, g1_neg(F, cur))
            term = _gt_term(F, qb, *_line(F, cur, two_neg_t))
            f = gt_mul(F, d, gt_mul(F, d, f, f), term)
            cur = g1_double(F, cur)
        else:
            # f <- f * line(T, P)(Q); T <- T + P
            f = gt_mul(F, d, f, _gt_term(F, qb, *_line(F, cur, base)))
            cur = g1_add(F, cur, base)
    return f


def gt_pow_scan(F, d_const: int, x: GT, e: int) -> GT:
    """x^e for a static exponent, MSB-first square-and-multiply."""
    if e == 0:
        return GT.one(F, x.a.shape, x.a.device)
    acc = x
    for bit in bin(e)[3:]:
        acc = gt_mul(F, d_const, acc, acc)
        if bit == "1":
            acc = gt_mul(F, d_const, acc, x)
    return acc


def final_exponentiation(F, curve, f: GT) -> GT:
    """f^((p^k - 1)/r) with the Frobenius split for exponents >= p."""
    e = curve.final_exp
    p = F.p
    if e >= p:
        hi = gt_pow_scan(F, curve.d, f, e // p)
        lo = gt_pow_scan(F, curve.d, f, e % p)
        return gt_mul(F, curve.d, gt_conj(F, hi), lo)
    return gt_pow_scan(F, curve.d, f, e)


def pairing(F, curve, p: G1, q: G2) -> GT:
    """Full pairing e(P, Q); e(infinity, Q) = 1."""
    out = final_exponentiation(F, curve, miller_loop(F, curve, p, q))
    one = GT.one(F, out.a.shape, out.a.device)
    return GT(_sel(p.inf, one.a, out.a), _sel(p.inf, one.b, out.b))
