"""Dense polynomial helpers over a prime field: port of the parts of
`plonk_tpu/ops/poly.py` that the scaled prover calls.

Polynomials are fixed-length int64 coefficient tensors in ascending
degree; trailing zeros are value-neutral.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def pad_to(c: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad the last axis to `length` (no-op if already that long)."""
    cur = c.shape[-1]
    if cur == length:
        return c
    if cur > length:
        raise ValueError(f"cannot pad {cur} down to {length}")
    return TF.pad(c, (0, length - cur))


def padd(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-1], b.shape[-1])
    return F.add(pad_to(a, L), pad_to(b, L))


def psub(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-1], b.shape[-1])
    return F.sub(pad_to(a, L), pad_to(b, L))


def pscale(F, a: torch.Tensor, s) -> torch.Tensor:
    return F.mul(a, s)


def padd_const(F, a: torch.Tensor, s) -> torch.Tensor:
    """Add a scalar to the constant term."""
    out = a.clone()
    out[..., 0] = F.add(a[..., 0], s)
    return out


def scan(op, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of a commutative, associative `op` along the last
    axis in log2(n) doubling steps (the counterpart of
    jax.lax.associative_scan for field add and mul: field results do not
    depend on the order of combination)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = torch.cat([x[..., :k], op(x[..., k:], x[..., :-k])], dim=-1)
        k *= 2
    return x


def _suffix_sums(F, u: torch.Tensor) -> torch.Tensor:
    """Inclusive modular suffix sums along the last axis."""
    return torch.flip(scan(F.add, torch.flip(u, dims=[-1])), dims=[-1])


def pow_vector(F, x: torch.Tensor, L: int) -> torch.Tensor:
    """pows[i] = x^i for i in [0, L) from the binary decomposition of i."""
    nbits = max((L - 1).bit_length(), 1)
    idx = torch.arange(L, device=x.device)
    acc = F.ones((L,), x.device)
    cur = x
    for j in range(nbits):
        bit = ((idx >> j) & 1) == 1
        acc = torch.where(bit, F.mul(acc, cur), acc)
        if j + 1 < nbits:
            cur = F.mul(cur, cur)
    return acc


def divide_by_linear(F, t: torch.Tensor, c: torch.Tensor):
    """Division by (x - c) for nonzero c, data-parallel:
    q[i] = (suffix sum of t_j c^j over j > i) * c^{-(i+1)}; the remainder
    is t(c). Returns (q, rem) with q of length len(t) - 1."""
    L = t.shape[-1]
    u = F.mul(t, pow_vector(F, c, L))
    suf = _suffix_sums(F, u)                       # suf[i] = sum_{j>=i}
    s_excl = F.sub(suf, u)                         # sum_{j>i}
    ic = F.inv(c)
    icpow = F.mul(pow_vector(F, ic, L), ic)        # ic^1 .. ic^L
    q = F.mul(s_excl, icpow)[..., :L - 1]
    rem = suf[..., 0]                              # t(c)
    return q, rem
