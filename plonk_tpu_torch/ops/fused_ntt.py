"""Fused four-step transforms: scrambled evaluation order, no bit reversal.

Port of `plonk_tpu/ops/fused_ntt.py`. With n = n1 * n2, i = i1*n2 + i2 and
k = k1 + n1*k2:

    X[k1 + n1 k2] = sum_{i2} w^{i2 k1} (w^{n1})^{i2 k2}
                        [ sum_{i1} A[i1, i2] (w^{n2})^{i1 k1} ]

`fused_ntt` (natural coefficients in, SCRAMBLED evaluations out) is the
five-step form: transpose, DIF row transforms of size n1, the twiddle
w^{i2 k1}, transpose, DIF row transforms of size n2. The output position
rev(k1)*n2 + rev(k2) holds X[k1 + n1 k2] (`scrambled_perm`). `fused_intt`
is the mirror with DIT rows and the 1/n scale, so the bit reversals of the
two cancel: pointwise algebra between them needs no unscramble. The row
passes are K5 (`row_stages.row_transform`).

`fused_ntt_1k` / `fused_intt_1k` compute the same arrays with the whole
transform of each batch element in one launch: K6 (`onepass_ntt`, CUDA
kernel `csrc/onepass_ntt.cu`), whose plain version `onepass_plain` is
the five-step composition above.

The BN254 path uses the layout helpers `_split`, `_bitrev` and
`scrambled_perm` too.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from .field import mont_mul
from .ntt import _check_root, _stage_tables
from .row_stages import row_transform, row_transform_plain

MAX_ROW = 2048           # csrc/onepass_ntt.cu: a row fits one tile
ONEPASS_ALL = 7          # K6's pass mask: first pass, grid barrier, second


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


@functools.lru_cache(maxsize=None)
def _twiddle_std(p: int, w: int, n1: int, n2: int,
                 inverse: bool) -> np.ndarray:
    """(n2, n1) standard-form table w^{+-i2*k1}, natural k1 order."""
    wq = pow(w, -1, p) if inverse else w
    row = np.array([pow(wq, k, p) for k in range(n1)], dtype=np.int64)
    out = np.empty((n2, n1), dtype=np.int64)
    acc = np.ones(n1, dtype=np.int64)
    for i2 in range(n2):
        out[i2] = acc
        acc = acc * row % p          # < 2^62: no int64 overflow
    return out


@functools.lru_cache(maxsize=None)
def _twiddle_matrix(p: int, w: int, n1: int, n2: int,
                    inverse: bool) -> np.ndarray:
    """(n2, n1) table w^{+-i2*k1} with the k1 axis bit-reversed (the DIF
    row output order)."""
    return _twiddle_std(p, w, n1, n2, inverse)[:, _bitrev(n1)].copy()


@functools.lru_cache(maxsize=64)
def _row_tables(F, w_row: int, n_row: int, device) -> torch.Tensor:
    """(log2 n_row, n_row) Montgomery lane twiddles of a full row
    transform with root w_row ((0, 1) for n_row = 1)."""
    tables = _stage_tables(F.p, w_row, n_row, n_row)
    return F.array(np.stack(tables) if tables
                   else np.zeros((0, n_row), dtype=np.int64), device)


@functools.lru_cache(maxsize=64)
def _tw_mat(F, w: int, n1: int, n2: int, inverse: bool, transposed: bool,
            device) -> torch.Tensor:
    """Montgomery _twiddle_matrix on `device`, (n2, n1) or its (n1, n2)
    transpose."""
    t = _twiddle_matrix(F.p, w, n1, n2, inverse)
    return F.array(np.ascontiguousarray(t.T) if transposed else t, device)


def _row_pass(F, x2d: torch.Tensor, w_row: int, n_row: int,
              dif: bool) -> torch.Tensor:
    """Full size-n_row transforms on the rows of x2d (rows, n_row): K5."""
    return row_transform(F.p, F.n_prime, x2d.contiguous(),
                         _row_tables(F, w_row, n_row, x2d.device), dif)


def fused_ntt(F, x: torch.Tensor, w: int,
              inverse: bool = False) -> torch.Tensor:
    """Forward transform, batched over leading dims: natural-order input,
    SCRAMBLED-layout output (see scrambled_perm). `inverse=True` uses the
    inverse root (unscaled inverse transform, still scrambled out)."""
    n = x.shape[-1]
    _check_root(F.p, w, n)
    batch = tuple(x.shape[:-1])
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    wq = pow(w, -1, F.p) if inverse else w
    a = x.reshape(nb, n1, n2).transpose(1, 2).reshape(nb * n2, n1)
    a = _row_pass(F, a, pow(wq, n2, F.p), n1, True).reshape(nb, n2, n1)
    a = F.mul(a, _tw_mat(F, w, n1, n2, inverse, False, x.device))
    a = a.transpose(1, 2).reshape(nb * n1, n2)      # (nb, rev(k1), i2)
    return _row_pass(F, a, pow(wq, n1, F.p), n2, True).reshape(batch + (n,))


def fused_intt(F, y: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse transform: SCRAMBLED-layout input (fused_ntt's output),
    natural-order coefficients out, scaled by 1/n."""
    n = y.shape[-1]
    batch = tuple(y.shape[:-1])
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    w_inv = pow(w, -1, F.p)
    a = _row_pass(F, y.reshape(nb * n1, n2), pow(w_inv, n1, F.p), n2,
                  False).reshape(nb, n1, n2)           # cols natural i2
    a = a.transpose(1, 2)                              # (nb, i2, rev(k1))
    a = F.mul(a, _tw_mat(F, w, n1, n2, True, False, y.device))
    a = _row_pass(F, a.reshape(nb * n2, n1), pow(w_inv, n2, F.p), n1,
                  False).reshape(nb, n2, n1)           # natural i1
    a = a.transpose(1, 2).reshape(batch + (n,))
    return F.mul(a, F.const(pow(n, -1, F.p)))


# ---------------- K6: the whole transform in one launch ----------------

@functools.lru_cache(maxsize=64)
def onepass_tables(F, w: int, n: int, inverse: bool, device) -> tuple:
    """K6's tables for the size-n transform with root w (its inverse if
    `inverse`), made once per (root, size, device): the lane twiddles of
    axis 0 (log2 n1, n1), the middle twiddle (n1, n2) and the lane
    twiddles of axis 1 (log2 n2, n2), Montgomery words packed as int32
    (p < 2^31), which the kernel reads as uint32."""
    p = F.p
    n1, n2 = _split(n)
    wq = pow(w, -1, p) if inverse else w
    return tuple(t.to(torch.int32) for t in (
        _row_tables(F, pow(wq, n2, p), n1, device),
        _tw_mat(F, w, n1, n2, inverse, True, device),
        _row_tables(F, pow(wq, n1, p), n2, device)))


def onepass_plain(p: int, n_prime: int, y: torch.Tensor, tw1: torch.Tensor,
                  twm: torch.Tensor, tw2: torch.Tensor, mirror: bool,
                  scale: int | None) -> torch.Tensor:
    """K6's function on y (nb, n1, n2), in plain PyTorch: mirror=False runs
    DIF along axis 0 (tables tw1), the twiddle twm (n1, n2), DIF along
    axis 1 (tw2); mirror=True runs DIT along axis 1, the twiddle, DIT along
    axis 0, then the product by `scale` (a Montgomery word) if given. The
    tables may be int64 or onepass_tables' int32 words."""
    tw1, twm, tw2 = (t.to(torch.int64) for t in (tw1, twm, tw2))

    def axis0(a, dif):
        return row_transform_plain(p, n_prime, a.transpose(1, 2), tw1,
                                   dif).transpose(1, 2)

    if not mirror:
        a = mont_mul(axis0(y, True), twm, p, n_prime)
        return row_transform_plain(p, n_prime, a, tw2, True)
    a = mont_mul(row_transform_plain(p, n_prime, y, tw2, False), twm, p,
                 n_prime)
    a = axis0(a, False)
    return a if scale is None else mont_mul(a, scale, p, n_prime)


def onepass_ntt(p: int, n_prime: int, y: torch.Tensor, tw1: torch.Tensor,
                twm: torch.Tensor, tw2: torch.Tensor, mirror: bool,
                scale: int | None) -> torch.Tensor:
    """The whole four-step transform of each (n1, n2) matrix of y
    (nb, n1, n2), as onepass_plain. A CPU tensor takes the plain version;
    a CUDA tensor launches K6 once, with onepass_tables' int32 tables."""
    if y.device.type == "cpu":
        return onepass_plain(p, n_prime, y, tw1, twm, tw2, mirror, scale)
    if y.device.type != "cuda" or any(t.device != y.device
                                      for t in (tw1, twm, tw2)):
        raise ValueError("onepass_ntt: y and the tables must be on one CUDA "
                         "device")
    if y.dtype != torch.int64 or not y.is_contiguous() or any(
            t.dtype != torch.int32 or not t.is_contiguous()
            for t in (tw1, twm, tw2)):
        raise TypeError("onepass_ntt: contiguous int64 words and int32 "
                        "tables (onepass_tables) expected")
    if y.dim() != 3:
        raise ValueError("onepass_ntt: y must be (nb, n1, n2)")
    nb, n1, n2 = y.shape
    if p >= 1 << 30:
        raise ValueError("onepass_ntt: the kernel's lazy residues need "
                         "p < 2^30")
    S1, S2 = n1.bit_length() - 1, n2.bit_length() - 1
    if n1 & (n1 - 1) or n2 & (n2 - 1) or not 1 <= n1 <= n2 <= MAX_ROW \
            or n2 < 2:
        raise ValueError(f"onepass_ntt: (n1, n2) = ({n1}, {n2}) must be "
                         f"powers of two with n1 <= n2 in [2, {MAX_ROW}]")
    if (tuple(tw1.shape) != (S1, n1) or tuple(tw2.shape) != (S2, n2)
            or tuple(twm.shape) != (n1, n2)):
        raise ValueError("onepass_ntt: tables must be (log2 n1, n1), "
                         "(n1, n2) and (log2 n2, n2)")
    out = torch.empty_like(y)
    if nb == 0:
        return out
    err = kernels.library().onepass_ntt_launch(
        y.data_ptr(), tw1.data_ptr(), twm.data_ptr(), tw2.data_ptr(),
        out.data_ptr(), nb, n1, n2, int(mirror),
        0 if scale is None else scale, int(scale is not None), p, n_prime,
        ONEPASS_ALL, torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(err, "onepass_ntt")
    return out


def _onepass(F, x: torch.Tensor, w: int, inverse: bool, mirror: bool,
             intt_scale: bool) -> torch.Tensor:
    n = x.shape[-1]
    _check_root(F.p, w, n)
    batch = tuple(x.shape[:-1])
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    out = onepass_ntt(
        F.p, F.n_prime, x.reshape(nb, n1, n2).contiguous(),
        *onepass_tables(F, w, n, inverse, x.device), mirror,
        F.const(pow(n, -1, F.p)) if intt_scale else None)
    return out.reshape(batch + (n,))


def fused_ntt_1k(F, x: torch.Tensor, w: int,
                 inverse: bool = False) -> torch.Tensor:
    """fused_ntt as one K6 launch per call (natural in, scrambled out; the
    same words as fused_ntt)."""
    return _onepass(F, x, w, inverse, mirror=False, intt_scale=False)


def fused_intt_1k(F, y: torch.Tensor, w: int) -> torch.Tensor:
    """fused_intt as one K6 launch per call (scrambled in, natural
    1/n-scaled coefficients out; the same words as fused_intt)."""
    return _onepass(F, y, w, inverse=True, mirror=True, intt_scale=True)
