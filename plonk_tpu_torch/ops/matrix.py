"""Modular dense-matrix utilities: port of `plonk_tpu/ops/matrix.py`
(parity with src/matrix.h).

The prover interpolates with the INTT (ops/ntt.py), which computes the
same product as the reference's Gauss-Jordan inverse of the Vandermonde
matrix (src/plonk.h:106-113). This module checks that equality and the
golden h_pows_inv. Gauss-Jordan and inversion run on the host on numpy
int64 (O(n^3) sequential test utilities); mat_add and mat_mul act on
tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def mat_add(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.add(a, b)


def mat_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) with modular accumulation (src/matrix.h:81-98)."""
    k = a.shape[-1]
    acc = F.mul(a[..., :, 0:1], b[..., 0, :][..., None, :])
    for i in range(1, k):
        acc = F.add(acc, F.mul(a[..., :, i:i + 1], b[..., i, :][..., None, :]))
    return acc


def gauss_jordan_host(p: int, mat: np.ndarray) -> np.ndarray:
    """Reference Gauss-Jordan (src/matrix.h:100-149) on the host, with its
    pivot search and row-swap order."""
    m = np.array(mat, dtype=np.int64) % p
    rows, cols = m.shape
    lead = 0
    for r in range(rows):
        if cols <= lead:
            return m
        i = r
        while m[i, lead] == 0:
            i += 1
            if i == rows:
                i = r
                lead += 1
                if lead == cols:
                    return m
        if i != r:
            m[[i, r]] = m[[r, i]]
        div = int(m[r, lead])
        if div != 0:
            m[r] = (m[r] * pow(div, p - 2, p)) % p
        for i2 in range(rows):
            if i2 != r:
                mult = m[i2, lead]
                m[i2] = (m[i2] - m[r] * mult) % p
        lead += 1
    return m


def mat_inv_host(p: int, mat: np.ndarray) -> np.ndarray:
    """Matrix inverse through the augmented [M | I] (src/matrix.h:151-176)."""
    mat = np.asarray(mat, dtype=np.int64) % p
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError("only square matrices can be inverted")
    aug = np.zeros((n, 2 * n), dtype=np.int64)
    aug[:, :n] = mat
    aug[np.arange(n), np.arange(n) + n] = 1
    return gauss_jordan_host(p, aug)[:, n:]


def vandermonde_host(p: int, points) -> np.ndarray:
    """h_pows[r][c] = points[r]^c (src/plonk.h:106-111)."""
    pts = np.asarray(points, dtype=np.int64) % p
    n = len(pts)
    m = np.empty((n, n), dtype=np.int64)
    for r in range(n):
        cur = 1
        for c in range(n):
            m[r, c] = cur
            cur = (cur * int(pts[r])) % p
    return m
