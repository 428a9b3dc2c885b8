"""Radix-2 number-theoretic transform (NTT/INTT) over prime fields.

Port of `plonk_tpu/ops/ntt.py`: iterative Cooley-Tukey DIT, with the
twiddle tables computed on the host with Python ints and cached.

The blocked layout views the n elements as (R, C) rows, C = min(n, 1024).
The log2(C) stages with butterfly distance < C act within rows and run as
ONE pass through `row_stages` (K1: the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); the stages with distance >= C pair whole
rows and stay in PyTorch. Transforms with n < 4096 use the plain reshape
butterfly instead (the "simple" layout), which is all a direct `Field`
(the toy F_17, n = 4) takes: K1 needs Montgomery words.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .row_stages import row_stages

_ROW = 1024


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _twiddle_table(p: int, w: int, n: int) -> np.ndarray:
    """Powers w^0 .. w^(n/2 - 1) (host-side, standard form)."""
    tw = np.empty(n // 2, dtype=np.int64)
    cur = 1
    for i in range(n // 2):
        tw[i] = cur
        cur = (cur * w) % p
    return tw


@functools.lru_cache(maxsize=None)
def _stage_tables(p: int, w: int, n: int, C: int):
    """Per-stage twiddle tables (host): for half < C a length-C lane vector
    tw[(j mod half) * stride]; for half >= C a (D, C) row-block matrix."""
    tw = _twiddle_table(p, w, n)
    tables = []
    half = 1
    while half < n:
        stride = n // (2 * half)
        if half < C:
            j = np.arange(C)
            tables.append(tw[(j % half) * stride])
        else:
            j = np.arange(half)
            tables.append(tw[j * stride].reshape(half // C, C))
        half *= 2
    return tuple(tables)


@functools.lru_cache(maxsize=64)
def _device_tables(F, w: int, n: int, C: int, device: torch.device):
    """Montgomery-form stage tables on `device`: (intra-row stack of shape
    (log2 C, C), tuple of cross-row (D, C) tables). K1 makes the intra-row
    stack's compact form at its first use and keeps it with the stack."""
    tables = _stage_tables(F.p, w, n, C)
    n_intra = C.bit_length() - 1
    intra = F.array(np.stack(tables[:n_intra]), device)
    cross = tuple(F.array(t, device) for t in tables[n_intra:])
    return intra, cross


@functools.lru_cache(maxsize=64)
def _perm_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_bit_reverse_perm(n), device=device)


def _bit_reverse(x: torch.Tensor, n: int) -> torch.Tensor:
    """Bit-reversal permutation along the last axis (one gather)."""
    return x.index_select(-1, _perm_on(n, x.device))


def _check_root(p: int, w: int, n: int):
    if pow(w, n, p) != 1 or (n > 1 and pow(w, n // 2, p) == 1):
        raise ValueError(f"{w} is not a primitive order-{n} root mod {p}")


def ntt(F, x: torch.Tensor, w: int) -> torch.Tensor:
    """Forward transform y[k] = sum_i x[i] * w^(ik) along the last axis,
    batched over leading dims. `w` is a primitive n-th root (Python int,
    standard form); n = x.shape[-1] is a power of two. Blocked layout for
    n >= 4096, simple otherwise."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("NTT size must be a power of two")
    if n == 1:
        return x
    _check_root(F.p, w, n)
    if n < 4096:
        return _ntt_simple(F, x, w)
    C = min(n, _ROW)
    R = n // C
    intra, cross = _device_tables(F, w, n, C, x.device)

    y = _bit_reverse(x, n)
    batch = tuple(y.shape[:-1])
    nbatch = math.prod(batch)
    # intra-row stages are row-independent: fold the batch into the rows
    rows = row_stages(F.p, F.n_prime, y.reshape(nbatch * R, C).contiguous(),
                      intra)
    y = rows.reshape(batch + (R, C))
    for tv in cross:
        D = tv.shape[0]
        yv = y.reshape(batch + (R // (2 * D), 2, D, C))
        even = yv[..., 0, :, :]
        odd = F.mul(yv[..., 1, :, :], tv)
        y = torch.stack([F.add(even, odd), F.sub(even, odd)],
                        dim=-3).reshape(batch + (R, C))
    return y.reshape(batch + (n,))


def _ntt_simple(F, x: torch.Tensor, w: int) -> torch.Tensor:
    """Reshape-butterfly DIT."""
    n = x.shape[-1]
    tw_all = F.array(_twiddle_table(F.p, w, n), x.device)
    y = _bit_reverse(x, n)
    batch = tuple(y.shape[:-1])
    half = 1
    while half < n:
        stride = n // (2 * half)
        tw = tw_all[::stride][:half]
        yv = y.reshape(batch + (n // (2 * half), 2, half))
        even = yv[..., 0, :]
        odd = F.mul(yv[..., 1, :], tw)
        y = torch.cat([F.add(even, odd), F.sub(even, odd)],
                      dim=-1).reshape(batch + (n,))
        half *= 2
    return y


def intt(F, x: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse transform with the forward root `w`:
    coeffs[i] = (1/n) sum_k x[k] w^(-ik)."""
    n = x.shape[-1]
    y = ntt(F, x, pow(w, -1, F.p))
    return F.mul(y, F.const(pow(n, -1, F.p)))


def interpolate(F, values: torch.Tensor, w: int) -> torch.Tensor:
    """The reference's interpolate_at_h (src/plonk.h:162-195): coefficients
    of the unique degree < n polynomial taking `values` on
    H = {w^0 .. w^(n-1)}; equal to h_pows_inv @ values."""
    return intt(F, values, w)


def evaluate_on_domain(F, coeffs: torch.Tensor, w: int, n: int
                       ) -> torch.Tensor:
    """Evaluate a (padded) coefficient vector on the order-n domain of w."""
    from .poly import pad_to
    return ntt(F, pad_to(coeffs, n), w)


def ntt_mul(F, a: torch.Tensor, b: torch.Tensor, root_fn=None
            ) -> torch.Tensor:
    """Polynomial product through the NTT, static length la + lb - 1. The
    field needs 2-adicity >= log2 of the next power of two of that."""
    from .poly import pad_to
    L = a.shape[-1] + b.shape[-1] - 1
    n = 1 << (L - 1).bit_length()
    w = F.params.root_of_unity(n) if root_fn is None else root_fn(n)
    fa = ntt(F, pad_to(a, n), w)
    fb = ntt(F, pad_to(b, n), w)
    return intt(F, F.mul(fa, fb), w)[..., :L]
