"""Structured reference string (trusted setup).

Port of `plonk_tpu/models/srs.py::SRS` and `srs_create`, both modes:

- "reference": the C reference's srs_create, including its degenerate
  base point (the identity, so every G1 power is infinity) and its power
  loop that starts at s^1 for index 0, with powers accumulated mod p.
- "fixed": g1s[i] = s^i * G with the real generator and the powers
  accumulated mod the group order r, as KZG requires.

G2 side in both modes: (g2_1, g2_s) = (G2_gen, secret * G2_gen).

Commitments for small scalar fields: the naive per-coefficient fold
(src/srs.h:53-68) and the fixed-base table of every multiple k * g1s[i],
k < r, which makes a commitment gathers and a fold. Both take leading
batch dimensions on the coefficients and give the same points.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.curve import (G1, G2, g1_add, g1_generator, g1_mul, g2_generator,
                         g2_mul)
from ..utils.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class SRS:
    g1s: G1          # batched: tensors of shape (n+1,)
    g2_1: G2
    g2_s: G2
    mode: str

    @property
    def length(self) -> int:
        return self.g1s.x.shape[-1]


def srs_create(Fq, curve, secret: int, n: int, mode: str = "reference",
               device=None) -> SRS:
    """Build the SRS with n+1 G1 powers on `device` (default: the CUDA
    card; pass device="cpu" for the CPU)."""
    device = resolve_device(device)
    length = n + 1
    if mode == "reference":
        secret = secret % Fq.p
        powers = []
        cur = secret
        for _ in range(length):
            powers.append(cur)
            cur = (cur * secret) % Fq.p
    else:
        s = secret % curve.r
        powers = []
        cur = 1
        for _ in range(length):
            powers.append(cur)
            cur = (cur * s) % curve.r
    powers = torch.tensor(powers, dtype=torch.int64, device=device)

    if mode == "reference":
        base = G1.identity((), device)
    elif mode == "fixed":
        base = g1_generator(curve, Fq, device)
    else:
        raise ValueError(f"unknown SRS mode {mode!r}")

    g1s = g1_mul(Fq, base, powers)      # batched ladder over all powers
    g2_1 = g2_generator(curve, Fq, device)
    if mode == "fixed":
        g2_s = g2_mul(Fq, curve.d, g2_1, secret % curve.r,
                      nbits=max(curve.r.bit_length(), 2))
    else:
        g2_s = g2_mul(Fq, curve.d, g2_1, secret % (1 << 32))
    return SRS(g1s=g1s, g2_1=g2_1, g2_s=g2_s, mode=mode)


def srs_multiple_table(Fq, srs_g1s: G1, r: int) -> G1:
    """Fixed-base precomputation for a small scalar field: table[i, k] =
    k * g1s[i] for k in [0, r), shape (len(g1s), r)."""
    scalars = torch.arange(r, dtype=torch.int64, device=srs_g1s.x.device)
    pts = G1(srs_g1s.x[:, None], srs_g1s.y[:, None], srs_g1s.inf[:, None])
    return g1_mul(Fq, pts, scalars[None, :], nbits=max(r.bit_length(), 1))


def _fold(Fq, terms: G1) -> G1:
    """Sum of the points along the last axis, in index order."""
    acc = G1.identity(terms.x.shape[:-1], terms.x.device)
    for i in range(terms.x.shape[-1]):
        acc = g1_add(Fq, acc, G1(terms.x[..., i], terms.y[..., i],
                                 terms.inf[..., i]))
    return acc


def srs_commit_table(Fq, table: G1, coeffs: torch.Tensor) -> G1:
    """Commitment through the fixed-base table: one gather per SRS point,
    then a fold. The same points as srs_commit_naive."""
    L = min(coeffs.shape[-1], table.x.shape[0])
    rows = torch.arange(L, device=coeffs.device)
    idx = coeffs[..., :L]
    return _fold(Fq, G1(table.x[rows, idx], table.y[rows, idx],
                        table.inf[rows, idx]))


def srs_commit_naive(Fq, srs_g1s: G1, coeffs: torch.Tensor,
                     scalar_bits: int = 32) -> G1:
    """Naive MSM fold sum_i coeffs[..., i] * g1s[i] in index order
    (src/srs.h:53-68) over min(len(coeffs), len(g1s)) terms; zero-padded
    coefficients add the identity. scalar_bits bounds the ladder (the
    scalar field's bit length)."""
    L = min(coeffs.shape[-1], srs_g1s.x.shape[-1])
    pts = G1(srs_g1s.x[:L], srs_g1s.y[:L], srs_g1s.inf[:L])
    return _fold(Fq, g1_mul(Fq, pts, coeffs[..., :L], nbits=scalar_bits))
