"""Fixed-base MSM: precomputed window tables + term selection + tree sum.

Port of `plonk_tpu/ops/fixed_base.py`. Every commitment of the prover and
the verifying key is an MSM against the same SRS points, so

  precompute  T[w][d][i] = d * 2^(w*window_bits) * P_i   (once per SRS)
  commit      sum over (w, i) of T[w][digit(s_i, w)][i]

The plain path here selects the terms with a gather (or with the bucket
sweep of `select_terms_many`) and sums them with a binary tree of complete
Jacobian additions. The CUDA kernel for the batched commit is in
`ops/commit.py`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .curve import G1, G1J, jac_add, jac_double, jac_from_affine, \
    jac_to_affine


class FixedBaseTable(NamedTuple):
    """Affine window-multiple table: x, y (int64) and inf (bool) of shape
    (n_windows, n_buckets, L); row d = 0 of every window is the identity.
    `packed` is the copy the CUDA commit kernel reads
    (ops/commit.pack_commit_table), or None."""
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor
    window_bits: int
    packed: Optional[torch.Tensor] = None

    @property
    def n_windows(self) -> int:
        return self.x.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.x.shape[1]

    @property
    def length(self) -> int:
        return self.x.shape[2]


def build_fixed_base_table(F, pts: G1, window_bits: int,
                           scalar_bits: int) -> FixedBaseTable:
    """T[w][d] = d * 2^(w*window_bits) * pts for d in [0, 2^window_bits):
    the shifted bases by repeated doubling, the d-multiples by repeated
    addition batched over (windows, points), one affine conversion."""
    n_windows = -(-scalar_bits // window_bits)
    n_buckets = 1 << window_bits
    cur = jac_from_affine(F, pts)
    shifted = []
    for _ in range(n_windows):
        shifted.append(cur)
        for _ in range(window_bits):
            cur = jac_double(F, cur)
    bases = G1J(*(torch.stack([b[k] for b in shifted]) for k in range(3)))

    mult = [bases]                                       # 1 .. nb-1 times
    for _ in range(n_buckets - 2):
        mult.append(jac_add(F, mult[-1], bases))
    aff = jac_to_affine(F, G1J(*(torch.stack([m[k] for m in mult])
                                 for k in range(3))))    # (nb-1, W, L)
    L = pts.x.shape[-1]
    ident = G1.identity((1, n_windows, L), pts.x.device)
    x = torch.cat([ident.x, aff.x]).transpose(0, 1).contiguous()
    y = torch.cat([ident.y, aff.y]).transpose(0, 1).contiguous()
    inf = torch.cat([ident.inf, aff.inf]).transpose(0, 1).contiguous()
    return FixedBaseTable(x=x, y=y, inf=inf, window_bits=window_bits)


def _digits(table: FixedBaseTable, scalars: torch.Tensor) -> torch.Tensor:
    """Standard-form scalars (..., L) -> window digits (..., W, L)."""
    wb = int(table.window_bits)
    n_windows, n_buckets, _ = table.x.shape
    shifts = torch.arange(n_windows, device=scalars.device) * wb
    return (scalars[..., None, :] >> shifts[:, None]) & (n_buckets - 1)


def _terms_from(F, gx, gy, ginf) -> G1J:
    one = F.ones(gx.shape, gx.device)
    Z = torch.where(ginf, torch.zeros_like(one), one)
    return G1J(torch.where(ginf, one, gx), torch.where(ginf, one, gy), Z)


def _gather_terms(F, table: FixedBaseTable, scalars: torch.Tensor) -> G1J:
    """Standard-form scalars (..., L) -> the (..., W*L) Jacobian terms by
    gathering table[w][digit][i]."""
    digits = _digits(table, scalars)                     # (..., W, L)
    batch = digits.shape[:-2]
    W, nb, L = table.x.shape
    idx = digits.unsqueeze(-2)                           # (..., W, 1, L)

    def pick(a):
        a = a.expand(batch + (W, nb, L))
        return torch.gather(a, -2, idx).reshape(batch + (W * L,))

    return _terms_from(F, pick(table.x), pick(table.y), pick(table.inf))


def select_terms_many(F, table: FixedBaseTable,
                      scalars: torch.Tensor) -> G1J:
    """(B, L) scalars -> (B, W*L) Jacobian terms by a sweep over the bucket
    axis that selects into an accumulator (no gather): the same terms as
    `_gather_terms`."""
    B = scalars.shape[0]
    W, nb, L = table.x.shape
    digits = _digits(table, scalars)                     # (B, W, L)
    gx = torch.zeros((B, W, L), dtype=table.x.dtype, device=scalars.device)
    gy = torch.zeros_like(gx)
    ginf = torch.ones((B, W, L), dtype=torch.bool, device=scalars.device)
    for d in range(nb):
        hit = digits == d
        gx = torch.where(hit, table.x[:, d], gx)
        gy = torch.where(hit, table.y[:, d], gy)
        ginf = torch.where(hit, table.inf[:, d], ginf)
    shape = (B, W * L)
    return _terms_from(F, gx.reshape(shape), gy.reshape(shape),
                       ginf.reshape(shape))


def _tree_reduce(F, terms: G1J) -> G1J:
    """Binary EC sum along the last axis: log2 halving steps of complete
    Jacobian adds over contiguous halves, identity-padded to a power of
    two."""
    n = terms.X.shape[-1]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        pad = G1J.identity(F, terms.X.shape[:-1] + (m - n,), terms.X.device)
        terms = G1J(*(torch.cat([t, q], dim=-1) for t, q in zip(terms, pad)))
    while m > 1:
        h = m // 2
        terms = jac_add(F, G1J(*(t[..., :h] for t in terms)),
                        G1J(*(t[..., h:m] for t in terms)))
        m = h
    return G1J(*(t[..., 0] for t in terms))


def msm_fixed_base_many(F, table: FixedBaseTable, scalars_batch: torch.Tensor,
                        mode: str = "gather") -> G1:
    """Batched commitments: (B, L) scalars -> G1 batch of shape (B,).
    mode: "gather" (index the table) or "select" (bucket sweep)."""
    if mode == "select":
        terms = select_terms_many(F, table, scalars_batch)
    elif mode == "gather":
        terms = _gather_terms(F, table, scalars_batch)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return jac_to_affine(F, _tree_reduce(F, terms))
