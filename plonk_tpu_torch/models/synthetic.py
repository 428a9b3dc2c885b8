"""Synthetic circuits (port of `plonk_tpu/models/synthetic.py`).

square_chain_circuit(n): n multiplication gates computing the chain
x, x^2, x^4, ..., with copy constraints wiring b_i = a_i and
a_{i+1} = c_i (the scaled curve).
bn254_mul_circuit(n): the BN254 prover's bench circuit, n independent
multiplication gates over BN254-Fr as 16-bit-word arrays.
big_edge_rows: rows of 16-bit words that reach the reduction edges of a
size-C transform (K3's checks on the card); edge_rows the same for rows of
31-bit words (K1's).
"""
from __future__ import annotations

import numpy as np

from ..utils.params import BN254_FR

# copy-constraint wire tags (plonk_tpu/models/constraints.py:31)
COPYOF_A, COPYOF_B, COPYOF_C = 0, 1, 2


def square_chain_circuit(p: int, n: int, x0: int = 3):
    """Returns (selectors (5, n), copies (3, n, 2), a, b, c) as numpy arrays
    in standard form for the scalar field p. Gate i: a_i * b_i = c_i with
    b_i = a_i (squaring) and a_{i+1} = c_i (chaining)."""
    selectors = np.zeros((5, n), dtype=np.uint32)
    # rows: q_l, q_r, q_o, q_m, q_c  — mul gates: q_m = 1, q_o = -1
    selectors[2, :] = p - 1
    selectors[3, :] = 1

    # copy permutation cycles per wire variable:
    #   v_i at A_i, B_i and (for i >= 1) C_{i-1}:  A_i -> B_i -> C_{i-1} -> A_i
    #   v_0: A_0 -> B_0 -> A_0;  v_n only at C_{n-1} (fixed point)
    c_a = np.zeros((n, 2), dtype=np.int64)
    c_b = np.zeros((n, 2), dtype=np.int64)
    c_c = np.zeros((n, 2), dtype=np.int64)
    for i in range(n):
        c_a[i] = (COPYOF_B, i + 1)                 # A_i -> B_i
        if i == 0:
            c_b[i] = (COPYOF_A, 1)                 # B_0 -> A_0
        else:
            c_b[i] = (COPYOF_C, i)                 # B_i -> C_{i-1}
        if i < n - 1:
            c_c[i] = (COPYOF_A, i + 2)             # C_i -> A_{i+1}
        else:
            c_c[i] = (COPYOF_C, n)                 # C_{n-1} fixed point
    copies = np.stack([c_a, c_b, c_c])

    a = np.empty(n, dtype=np.uint32)
    cur = x0 % p
    for i in range(n):
        a[i] = cur
        cur = (cur * cur) % p
    b = a.copy()
    c = (a.astype(np.uint64) * a % p).astype(np.uint32)
    return selectors, copies, a, b, c


def bn254_mul_circuit(n: int, seed: int = 11):
    """The BN254 multiplication-gate circuit of the JAX package's BN254
    bench and tests: n gates c_i = a_i * b_i (q_m = 1, q_o = -1), the
    identity copy permutation, a and b drawn from a seeded numpy
    generator. Returns (selectors (5, n, 16), copies (3, n, 2), a, b, c
    as (n, 16)) standard-form 16-bit-word arrays."""
    r = BN254_FR.p
    rng = np.random.default_rng(seed)
    a = [int.from_bytes(rng.bytes(31), "little") % r for _ in range(n)]
    b = [int.from_bytes(rng.bytes(31), "little") % r for _ in range(n)]
    c = [x * y % r for x, y in zip(a, b)]
    sel = np.zeros((5, n, 16), dtype=np.uint32)
    sel[3] = words_vec([1] * n)                     # q_m = 1
    sel[2] = words_vec([r - 1] * n)                 # q_o = -1
    copies = np.stack([
        np.stack([np.full(n, t), np.arange(1, n + 1)], axis=-1)
        for t in range(3)]).astype(np.int32)
    return sel, copies, words_vec(a), words_vec(b), words_vec(c)


def words_vec(vals) -> np.ndarray:
    """Python ints -> (len, 16) standard-form 16-bit words (uint32)."""
    return np.array([[(int(v) >> (16 * k)) & 0xFFFF for k in range(16)]
                     for v in vals], dtype=np.uint32).reshape(-1, 16)


def from_words(w) -> int:
    """16-bit words (any integer array or tensor) -> Python int."""
    v = 0
    for word in reversed([int(x) for x in np.asarray(w).reshape(-1)]):
        v = (v << 16) | word
    return v


def big_edge_rows(p: int, R: int, C: int, dif: bool, rng) -> np.ndarray:
    """(R, C, 16) words of elements below p (254 bits, BN254's Fr or Fq)
    whose rows cycle through five kinds: random; zeros; p - 1; lo = hi;
    hi = p - lo (so that the first stage's sum is exactly p). lo and hi
    are the first stage's partners: the two halves of the row for DIF,
    neighbours for DIT."""
    vals = rng.integers(0, 1 << 16, size=(R, C, 16))
    vals[..., 15] &= 0x0FFF                          # < 2^252 < p
    pw = np.array([(p >> (16 * k)) & 0xFFFF for k in range(16)])
    vals[1::5] = 0
    pm1 = pw.copy()
    pm1[0] -= 1                                      # p is odd
    vals[2::5] = pm1
    v = vals.reshape(R, 2, C // 2, 16) if dif else vals.reshape(R, C // 2,
                                                                  2, 16)
    lo = v[:, 0] if dif else v[:, :, 0]
    hi = v[:, 1] if dif else v[:, :, 1]
    hi[3::5] = lo[3::5]
    lo[4::5] |= 1                                    # nonzero, so p - lo < p
    borrow = 0
    for k in range(16):
        d = pw[k] - lo[4::5, ..., k] - borrow
        borrow = (d < 0).astype(np.int64)
        hi[4::5, ..., k] = d + (borrow << 16)
    return vals


def edge_scan_words(p: int, D: int, m: int, rng) -> np.ndarray:
    """D * m words below p (Montgomery form, R = 2^32) for the sharded
    prefix product of D shards of m words: random words, p - 1, 1 and the
    Montgomery one in turn, and one zero, in the middle of shard D // 2,
    whose total is then zero and so every word of the later shards."""
    x = rng.integers(0, p, size=D * m)
    x[1::4] = p - 1
    x[2::4] = 1
    x[3::4] = (1 << 32) % p
    x[(D // 2) * m + m // 2] = 0
    return x.astype(np.int64)


def edge_rows(p: int, R: int, C: int, rng, half: int = 1) -> np.ndarray:
    """(R, C) words below p (one machine word, the scaled curve's Fr) whose
    rows cycle through five kinds: random; zeros; p - 1; lo = hi; hi = p -
    lo (so that the first stage's sum, whose twiddle is 1, is exactly p).
    lo and hi are the first stage's partners, `half` apart in the row:
    neighbours for the first DIT stage (half = 1), the two halves of the row
    for the first DIF stage (half = C / 2)."""
    vals = rng.integers(0, p, size=(R, C))
    vals[1::5] = 0
    vals[2::5] = p - 1
    pairs = vals.reshape(R, C // (2 * half), 2, half)
    lo, hi = pairs[:, :, 0], pairs[:, :, 1]
    hi[3::5] = lo[3::5]
    lo[4::5] = np.maximum(lo[4::5], 1)               # so p - lo < p
    hi[4::5] = p - lo[4::5]
    return vals
