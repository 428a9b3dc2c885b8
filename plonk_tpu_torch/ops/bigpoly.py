"""Polynomial kernels over multi-limb fields (`ops/bigfield.py`).

Port of `plonk_tpu/ops/bigpoly.py`: the same closed-form, data-parallel
algorithms on (..., n, limbs) tensors, the coefficient axis at -2 and
the 16-bit-word limb axis last. Leading axes are batch axes: a scalar of
shape (..., limbs) is one point or factor per lane (what the JAX package
gets from `vmap`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .bigfield import BigMontField


def pad_to(c: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad the coefficient axis (-2) to `length`."""
    n = c.shape[-2]
    if n > length:
        raise ValueError(f"cannot pad length {n} down to {length}")
    if n == length:
        return c
    return TF.pad(c, (0, 0, 0, length - n))


def stack_rows(rows) -> torch.Tensor:
    """Polynomials (..., L, limbs), their leading (lane) axes broadcast,
    stacked at the row axis -3: (..., k, L, limbs), each lane's k rows
    beside its lane axes."""
    shape = torch.broadcast_shapes(*(r.shape for r in rows))
    return torch.stack([r.expand(shape) for r in rows], dim=-3)


def padd(F: BigMontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-2], b.shape[-2])
    return F.add(pad_to(a, L), pad_to(b, L))


def psub(F: BigMontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-2], b.shape[-2])
    return F.sub(pad_to(a, L), pad_to(b, L))


def pscale(F: BigMontField, a: torch.Tensor, s: torch.Tensor
           ) -> torch.Tensor:
    """a * s with s a (..., limbs) scalar."""
    return F.mont_mul(a, s[..., None, :])


def padd_const(F: BigMontField, a: torch.Tensor, s: torch.Tensor
               ) -> torch.Tensor:
    """a + s (added to the constant term); a polynomial without the
    scalar's batch axes is broadcast to them."""
    a = a.expand(torch.broadcast_shapes(a.shape[:-2], s.shape[:-1])
                 + a.shape[-2:])
    return torch.cat([F.add(a[..., :1, :], s[..., None, :]), a[..., 1:, :]],
                     dim=-2)


def pow_vector(F: BigMontField, x: torch.Tensor, L: int) -> torch.Tensor:
    """pows[..., i, :] = x^i for i in [0, L) by the binary decomposition of
    i (log2 L full-width products); x (..., limbs) gives (..., L, limbs)."""
    nbits = max((L - 1).bit_length(), 1)
    idx = torch.arange(L, device=x.device)
    acc = F.ones(x.shape[:-1] + (L,), x.device)
    cur = x[..., None, :]
    for j in range(nbits):
        bit = ((idx >> j) & 1) == 1
        acc = torch.where(bit[:, None], F.mont_mul(acc, cur), acc)
        if j + 1 < nbits:
            cur = F.square(cur)
    return acc


def tree_sum(F: BigMontField, t: torch.Tensor) -> torch.Tensor:
    """Log-depth modular sum along axis -2 over contiguous halves."""
    L = t.shape[-2]
    m = 1 << (L - 1).bit_length() if L > 1 else 1
    t = pad_to(t, m)
    while m > 1:
        h = m // 2
        t = F.add(t[..., :h, :], t[..., h:, :])
        m = h
    return t[..., 0, :]


def peval(F: BigMontField, coeffs: torch.Tensor, x: torch.Tensor
          ) -> torch.Tensor:
    """Evaluate at a scalar point in O(log n) depth."""
    return tree_sum(F, F.mont_mul(coeffs, pow_vector(F, x,
                                                     coeffs.shape[-2])))


def suffix_sums(F: BigMontField, u: torch.Tensor) -> torch.Tensor:
    """Inclusive modular suffix sums along axis -2 (log-depth shifted
    adds)."""
    L = u.shape[-2]
    acc = torch.flip(u, dims=(-2,))
    k = 1
    while k < L:
        shifted = TF.pad(acc, (0, 0, k, 0))[..., :L, :]
        acc = F.add(acc, shifted)
        k *= 2
    return torch.flip(acc, dims=(-2,))


def divide_by_linear(F: BigMontField, t: torch.Tensor, c: torch.Tensor):
    """Division by (x - c), c (..., limbs) nonzero, fully data-parallel:
    q[i] = sum_{j>i} t[j] c^{j-i-1}. Returns (q, rem) with q of length
    len(t) - 1 and rem = t(c)."""
    L = t.shape[-2]
    u = F.mont_mul(t, pow_vector(F, c, L))
    suf = suffix_sums(F, u)
    s_excl = F.sub(suf, u)
    ic = F.inv(c)
    icpow = F.mont_mul(pow_vector(F, ic, L), ic[..., None, :])
    q = F.mont_mul(s_excl, icpow)[..., :L - 1, :]
    return q, suf[..., 0, :]


def batch_inv(F: BigMontField, a: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick inverse of (..., n, limbs) vectors: one Fermat
    inversion a vector and ~4n products; zero elements invert to 0. Equal
    word for word to F.inv per element (canonical words are unique)."""
    one = F.ones(a.shape[:-1], a.device)
    is_zero = (a == 0).all(-1, keepdim=True)
    b = torch.where(is_zero, one, a)
    pre = prefix_prod_chunked(F, b)                     # inclusive
    suf = torch.flip(prefix_prod_chunked(F, torch.flip(b, dims=(-2,))),
                     dims=(-2,))
    tot_inv = F.inv(pre[..., -1:, :])
    p_excl = torch.cat([one[..., :1, :], pre[..., :-1, :]], dim=-2)
    s_excl = torch.cat([suf[..., 1:, :], one[..., :1, :]], dim=-2)
    out = F.mont_mul(F.mont_mul(p_excl, s_excl), tot_inv)
    return torch.where(is_zero, torch.zeros_like(out), out)


def prefix_prod_chunked(F: BigMontField, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product of an (n, limbs) array along axis -2.
    The JAX package runs a chunked sequential scan, which XLA compiles
    into one loop; eagerly that would be one launch group per step, so
    here it is a log-depth (Hillis-Steele) scan: log2(n) products over
    the whole array. The products are the same field elements."""
    n = x.shape[-2]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d, :], F.mont_mul(x[..., d:, :],
                                                  x[..., :n - d, :])],
                      dim=-2)
        d *= 2
    return x
