"""BN254 extension-field tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), xi = 9 + u.

Port of the math of `plonk_tpu/ops/tower.py`. The JAX package nests
NamedTuples of limb arrays and row-stacks them to keep XLA:CPU compile
time down; here an element is ONE tensor whose coefficient axes sit
before the 16-bit-word limb axis:

    Fq2   (..., 2, limbs)          [c0, c1]
    Fq6   (..., 3, 2, limbs)       [c0, c1, c2]
    Fq12  (..., 2, 3, 2, limbs)    [c0, c1]

so that an addition, subtraction or negation of any tower element is the
base field's `add`, `sub` or `neg` on the whole tensor, and the
Karatsuba products of one step ride one Montgomery product. The JAX
package's `x.c0.c1` is `x[..., 0, 1, :, :]` here. All operations are
elementwise over the leading batch axes and return canonical words.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .bigfield import BigMontField

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
XI = (9, 1)


# ---- host-side Python-int Fq2 helpers (constants only) ----

def _h2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def _h2_conj(a):
    return (a[0], (-a[1]) % Q)


def _h2_pow(a, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = _h2_mul(r, a)
        a = _h2_mul(a, a)
        e >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _gamma_tables():
    """gamma1[i] = xi^(i(p-1)/6); gamma2, gamma3 for the p^2, p^3 maps."""
    g1 = [_h2_pow(XI, i * (Q - 1) // 6) for i in range(6)]
    g2 = [_h2_mul(g, _h2_conj(g)) for g in g1]
    g3 = [_h2_mul(a, b) for a, b in zip(g1, g2)]
    return g1, g2, g3


# ---- constructors ----

def f2_const(F: BigMontField, v: tuple, device) -> torch.Tensor:
    """Python-int pair -> Montgomery Fq2 tensor (2, limbs)."""
    return F.array(list(v), device)


def f2_one(F: BigMontField, shape, device) -> torch.Tensor:
    return torch.stack([F.ones(shape, device), F.zeros(shape, device)], -2)


def f2_zero(F: BigMontField, shape, device) -> torch.Tensor:
    return F.zeros(tuple(shape) + (2,), device)


def f12_one(F: BigMontField, shape, device) -> torch.Tensor:
    out = F.zeros(tuple(shape) + (2, 3, 2), device)
    out[..., 0, 0, 0, :] = torch.as_tensor(F.const(1), device=device)
    return out


def f12_encode_host(F: BigMontField, coeffs, device) -> torch.Tensor:
    """Nested Python ints ((Fq2, Fq2, Fq2), (Fq2, Fq2, Fq2)) in the layout
    of tests/bn254_oracle.py -> Fq12 tensor (2, 3, 2, limbs)."""
    return F.array(np.array(coeffs, dtype=object), device)


def f12_decode_host(F: BigMontField, a: torch.Tensor):
    v = F.decode_host(a)
    return tuple(tuple((int(v[i, j, 0]), int(v[i, j, 1])) for j in range(3))
                 for i in range(2))


# ---- Fq2 ----

def f2_conj(F, a):
    return torch.stack([a[..., 0, :], F.neg(a[..., 1, :])], -2)


def f2_mul(F, a, b):
    """Karatsuba (u^2 = -1): the three base products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    s = F.add(torch.stack([a[..., 0, :], b[..., 0, :]]),
              torch.stack([a[..., 1, :], b[..., 1, :]]))
    v = F.mont_mul(torch.stack([a[..., 0, :], a[..., 1, :], s[0]]),
                   torch.stack([b[..., 0, :], b[..., 1, :], s[1]]))
    c0 = F.sub(v[0], v[1])
    c1 = F.sub(F.sub(v[2], v[0]), v[1])
    return torch.stack([c0, c1], -2)


def f2_sq(F, a):
    return f2_mul(F, a, a)


def f2_mul_fq(F, a, s):
    """a * s with s a base-field element (..., limbs)."""
    return F.mont_mul(a, s[..., None, :])


def f2_mul_xi(F, a):
    """a * (9 + u) = (9 c0 - c1, c0 + 9 c1)."""
    a9 = F.mont_mul(a, F.const(9))
    return F.add(torch.stack([a9[..., 0, :], a[..., 0, :]], -2),
                 torch.stack([F.neg(a[..., 1, :]), a9[..., 1, :]], -2))


def f2_inv(F, a):
    """1/(c0 + c1 u) = (c0 - c1 u)/(c0^2 + c1^2); inv(0) = 0."""
    sq = F.mont_mul(a, a)
    ni = F.inv(F.add(sq[..., 0, :], sq[..., 1, :]))
    return f2_conj(F, F.mont_mul(a, ni[..., None, :]))


def f2_is_zero(F, a):
    return (a == 0).all(-1).all(-1)


# ---- Fq6 ----

_I6A = [0, 1, 2, 1, 0, 0]         # Karatsuba operands: x0 x1 x2 (x1+x2)
_I6B = [3, 3, 3, 2, 1, 2]         # (x0+x1) (x0+x2); index 3 is "zero"


def _f6_operands(F, a):
    """(..., 3, 2, L) -> (..., 6, 2, L): x0, x1, x2, x1+x2, x0+x1, x0+x2."""
    pad = torch.cat([a, torch.zeros_like(a[..., :1, :, :])], -3)
    return F.add(pad[..., _I6A, :, :], pad[..., _I6B, :, :])


def f6_mul(F, a, b):
    """Karatsuba over v: six Fq2 products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    v = f2_mul(F, _f6_operands(F, a), _f6_operands(F, b))
    v0, v1, v2 = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
    # [t12 - v1 - v2, t01 - v0 - v1, t02 - v0 - v2]
    x = F.sub(F.sub(v[..., 3:, :, :], v[..., [1, 0, 0], :, :]),
              v[..., [2, 1, 2], :, :])
    xi = f2_mul_xi(F, torch.stack([x[..., 0, :, :], v2], -3))
    return F.add(torch.stack([v0, x[..., 1, :, :], x[..., 2, :, :]], -3),
                 torch.stack([xi[..., 0, :, :], xi[..., 1, :, :], v1], -3))


def f6_mul_v(F, a):
    """v * a = xi c2 + c0 v + c1 v^2."""
    return torch.stack([f2_mul_xi(F, a[..., 2, :, :]), a[..., 0, :, :],
                        a[..., 1, :, :]], -3)


def f6_inv(F, a):
    c0, c1, c2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    sq0, m12, sq2, m01, sq1, m02 = f2_mul(
        F, torch.stack([c0, c1, c2, c0, c1, c0], -3),
        torch.stack([c0, c2, c2, c1, c1, c2], -3)).unbind(-3)
    t0 = F.sub(sq0, f2_mul_xi(F, m12))
    t1 = F.sub(f2_mul_xi(F, sq2), m01)
    t2 = F.sub(sq1, m02)
    d = f2_mul(F, torch.stack([c0, c2, c1], -3), torch.stack([t0, t1, t2],
                                                             -3))
    d = F.add(d[..., 0, :, :], f2_mul_xi(F, F.add(d[..., 1, :, :],
                                                  d[..., 2, :, :])))
    return f2_mul(F, torch.stack([t0, t1, t2], -3),
                  f2_inv(F, d)[..., None, :, :])


# ---- Fq12 ----

def f12_mul(F, a, b):
    """Karatsuba over w: the three Fq6 products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = (a[..., 0, :, :, :], a[..., 1, :, :, :],
                      b[..., 0, :, :, :], b[..., 1, :, :, :])
    s = F.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
    v = f6_mul(F, torch.stack([a0, a1, s[0]], -4),
               torch.stack([b0, b1, s[1]], -4))
    v0, v1 = v[..., 0, :, :, :], v[..., 1, :, :, :]
    c0 = F.add(v0, f6_mul_v(F, v1))
    c1 = F.sub(F.sub(v[..., 2, :, :, :], v0), v1)
    return torch.stack([c0, c1], -4)


def f12_sq(F, a):
    return f12_mul(F, a, a)


def f12_conj(F, a):
    """a^(p^6): negate the w part (the inverse on the cyclotomic
    subgroup)."""
    return torch.stack([a[..., 0, :, :, :], F.neg(a[..., 1, :, :, :])], -4)


def f12_inv(F, a):
    """1/(a0 + a1 w) = (a0 - a1 w) / (a0^2 - v a1^2)."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    sq = f6_mul(F, a, a)                         # [a0^2, a1^2]
    t = F.sub(sq[..., 0, :, :, :], f6_mul_v(F, sq[..., 1, :, :, :]))
    ti = f6_inv(F, t)
    out = f6_mul(F, torch.stack([a0, a1], -4), ti[..., None, :, :, :])
    return torch.stack([out[..., 0, :, :, :], F.neg(out[..., 1, :, :, :])],
                       -4)


def f12_eq(F, a, b):
    return (a == b).flatten(-4).all(-1)


@functools.lru_cache(maxsize=None)
def _gamma_rows_host(F: BigMontField, power: int) -> np.ndarray:
    """(2, 3, 2, limbs) Montgomery gamma twists of the p^power map: the
    Fq12 coefficient [i][j] has w-degree i + 2j."""
    g = _gamma_tables()[power - 1]
    return F.encode_host(np.array(
        [[g[i + 2 * j] for j in range(3)] for i in range(2)], dtype=object))


def gamma_rows(F: BigMontField, power: int, device) -> torch.Tensor:
    from .bigfield import device_table
    return device_table(_gamma_rows_host, (F, power), str(device))


def f12_frobenius(F, a, power: int = 1):
    """a^(p^power), power in {1, 2, 3}: conjugate every Fq2 coefficient
    (odd powers), then multiply by the constant gamma twists."""
    if power % 2 == 1:
        a = f2_conj(F, a)
    return f2_mul(F, a, gamma_rows(F, power, a.device))
