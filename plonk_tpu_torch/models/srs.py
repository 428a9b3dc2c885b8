"""Structured reference string (trusted setup).

Port of `plonk_tpu/models/srs.py::SRS` and `srs_create`, both modes:

- "reference": the C reference's srs_create, including its degenerate
  base point (the identity, so every G1 power is infinity) and its power
  loop that starts at s^1 for index 0, with powers accumulated mod p.
- "fixed": g1s[i] = s^i * G with the real generator and the powers
  accumulated mod the group order r, as KZG requires.

G2 side in both modes: (g2_1, g2_s) = (G2_gen, secret * G2_gen).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.curve import G1, G2, g1_generator, g1_mul, g2_generator, g2_mul
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
