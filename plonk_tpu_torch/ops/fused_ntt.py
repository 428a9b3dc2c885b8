"""Layout helpers of the four-step transform.

Port of the parts of `plonk_tpu/ops/fused_ntt.py` that the BN254 path
uses: the split n = n1 * n2, the bit reversal, and `scrambled_perm`,
which names the natural index of each position of the forward
transform's SCRAMBLED output (so that position-indexed tables can be
aligned with it on the host). The 31-bit fused transforms (TPU kernels
K5 and K6) are not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np


def _split(n: int):
    """n = n1 * n2 with both powers of two and n1 <= n2."""
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def scrambled_perm(n: int) -> np.ndarray:
    """perm[j] = natural index of the element the forward transform
    leaves at flat position j = rev(k1)*n2 + rev(k2)."""
    n1, n2 = _split(n)
    r1, r2 = _bitrev(n1), _bitrev(n2)
    k1 = np.empty(n1, dtype=np.int64)
    k1[r1] = np.arange(n1)
    k2 = np.empty(n2, dtype=np.int64)
    k2[r2] = np.arange(n2)
    a, b = np.meshgrid(k1, k2, indexing="ij")
    return (a + n1 * b).reshape(-1)
