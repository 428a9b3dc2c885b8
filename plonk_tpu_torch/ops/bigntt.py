"""K3: the 16-limb four-step transform over BN254-Fr.

Port of `plonk_tpu/ops/pallas_bigntt.py`: `big_fused_ntt` (natural
coefficients in, SCRAMBLED evaluations out, see
`fused_ntt.scrambled_perm`) and `big_fused_intt` (the mirror, scaled by
1/n). Each is two row passes of size-C transforms with the transposes and
the middle twiddle product between them in PyTorch (XLA in the JAX
package). `big_row_pass` is the row pass: on a CUDA tensor it launches the
hand-written kernel `csrc/big_row.cu`; on a CPU tensor it runs
`big_row_pass_plain`, the same stages in plain PyTorch.

Rows are laid out (R, C, limbs): elements along C, the 16-bit words last
(the TPU kernel kept limbs on sublanes, (R, limbs, C)). The outputs of the
two transforms are in the JAX package's layouts, word for word.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from .bigfield import BigMontField, _twiddle_words, device_table
from .fused_ntt import _bitrev, _split

MAX_ROW = 1024           # csrc/big_row.cu: a row and its twiddles in 48 KB


def _stage_values(p: int, w: int, C: int) -> list:
    """Per-stage length-C twiddle lists (Python ints): stage s (half =
    2^s) holds w^((j mod half) * C/(2 half)) at lane j."""
    tw = []
    cur = 1
    for _ in range(C // 2):
        tw.append(cur)
        cur = cur * w % p
    tables = []
    half = 1
    while half < C:
        stride = C // (2 * half)
        tables.append([tw[(j % half) * stride] for j in range(C)])
        half *= 2
    return tables


@functools.lru_cache(maxsize=64)
def _row_tables(F: BigMontField, w_row: int, C: int) -> np.ndarray:
    """(S, C, limbs) Montgomery words of the per-stage lane twiddles."""
    return np.stack([F.encode_host(np.asarray(t, dtype=object))
                     for t in _stage_values(F.p, w_row, C)])


def _packed_powers(F: BigMontField, w_row: int, C: int) -> np.ndarray:
    """(C/2, 8) int32 limbs of the Montgomery words of w_row^e, e < C/2:
    every distinct twiddle of a size-C row (stage s, lane j:
    _row_tables[s, j] is entry (j mod 2^s) << (S - 1 - s)), as K3 reads
    them, 32 bytes each."""
    words = _twiddle_words(F.p, w_row, C, F.limbs)
    return (words[:, 0::2] | (words[:, 1::2] << 16)).astype(
        np.uint32).view(np.int32)


def big_row_pass_plain(F: BigMontField, y: torch.Tensor, tw: torch.Tensor,
                       dif: bool, scale=None) -> torch.Tensor:
    """All log2(C) stages of the size-C transforms along axis 1 of y
    (R, C, limbs), in plain PyTorch: DIF from half = C/2 down to 1, or DIT
    from half = 1 up, then the product by `scale` (Montgomery words) when
    given. tw: (S, C, limbs) from _row_tables."""
    R, C, L = y.shape
    S = C.bit_length() - 1
    for k in range(S):
        s = S - 1 - k if dif else k
        half = 1 << s
        v = y.reshape(R, C // (2 * half), 2, half, L)
        lo, hi = v[:, :, 0], v[:, :, 1]
        w = tw[s].reshape(C // (2 * half), 2, half, L)[:, 1]
        if dif:
            new = (F.add(lo, hi), F.mont_mul(F.sub(lo, hi), w))
        else:
            t = F.mont_mul(hi, w)
            new = (F.add(lo, t), F.sub(lo, t))
        y = torch.stack(new, dim=2).reshape(R, C, L)
    if scale is not None:
        y = F.mont_mul(y, scale)
    return y


def big_row_pass(F: BigMontField, y: torch.Tensor, w_row: int, dif: bool,
                 scale: int | None = None) -> torch.Tensor:
    """Size-C transforms with root w_row along axis 1 of y (R, C, limbs),
    optionally times `scale` (a Python int). A CPU tensor takes the plain
    version; a CUDA tensor launches K3 or raises."""
    R, C, L = y.shape
    dev = str(y.device)
    if y.device.type == "cpu":
        return big_row_pass_plain(
            F, y, device_table(_row_tables, (F, w_row, C), dev), dif,
            None if scale is None else F.const(scale))
    if y.device.type != "cuda":
        raise ValueError(f"big_row_pass: unsupported device {y.device}")
    if y.dtype != torch.int64 or not y.is_contiguous() \
            or y.data_ptr() % 16:
        raise ValueError("big_row_pass: contiguous, 16-byte aligned int64 "
                         "words expected")
    if L != 16 or F.limbs != 16:
        raise ValueError("big_row_pass: the kernel takes 16-word elements")
    if C & (C - 1) or not 2 <= C <= MAX_ROW:
        raise ValueError(f"big_row_pass: C = {C} must be a power of two in "
                         f"[2, {MAX_ROW}]")
    out = torch.empty_like(y)
    if R == 0:
        return out
    pw = device_table(_packed_powers, (F, w_row, C), dev)
    err = kernels.library().big_row_launch(
        y.data_ptr(), pw.data_ptr(), out.data_ptr(), R, C,
        C.bit_length() - 1, int(dif), kernels.big_field_arg(F.p),
        kernels.u256_arg(0 if scale is None
                         else _words_int(F.const(scale))),
        int(scale is not None),
        torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(err, "big_row")
    return out


def _words_int(words) -> int:
    return sum(int(w) << (16 * k) for k, w in enumerate(words))


def _tw_mid_host(F: BigMontField, w: int, n1: int, n2: int,
                 inverse: bool) -> np.ndarray:
    """(n2, n1, limbs) Montgomery words of w^(+-i2*k1), k1 bit-reversed."""
    p = F.p
    wq = pow(w, -1, p) if inverse else w
    row = [pow(wq, k, p) for k in range(n1)]
    out = np.empty((n2, n1), dtype=object)
    acc = [1] * n1
    for i2 in range(n2):
        out[i2] = acc
        acc = [a * r % p for a, r in zip(acc, row)]
    return F.encode_host(out[:, _bitrev(n1)])


def _tw_mid(F: BigMontField, w: int, n1: int, n2: int, inverse: bool,
            device) -> torch.Tensor:
    return device_table(_tw_mid_host, (F, w, n1, n2, inverse), str(device))


def _check_root(p: int, w: int, n: int) -> None:
    if n & (n - 1) or n < 2:
        raise ValueError("NTT size must be a power of two >= 2")
    if pow(w, n, p) != 1 or pow(w, n // 2, p) == 1:
        raise ValueError(f"{w} is not a primitive order-{n} root mod {p}")


def big_fused_ntt(F: BigMontField, x: torch.Tensor, w: int,
                  inverse: bool = False) -> torch.Tensor:
    """Forward transform, batched over leading dims: x (..., n, limbs)
    natural-order Montgomery words -> SCRAMBLED-layout evaluations."""
    n, L = x.shape[-2], x.shape[-1]
    _check_root(F.p, w, n)
    batch = x.shape[:-2]
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    wq = pow(w, -1, F.p) if inverse else w
    a = x.reshape(nb, n1, n2, L).transpose(1, 2).reshape(nb * n2, n1, L)
    a = big_row_pass(F, a.contiguous(), pow(wq, n2, F.p), dif=True)
    a = F.mont_mul(a.reshape(nb, n2, n1, L),
                   _tw_mid(F, w, n1, n2, inverse, x.device))
    a = a.transpose(1, 2).reshape(nb * n1, n2, L)
    a = big_row_pass(F, a.contiguous(), pow(wq, n1, F.p), dif=True)
    return a.reshape(batch + (n, L))


def big_fused_intt(F: BigMontField, y: torch.Tensor, w: int
                   ) -> torch.Tensor:
    """Inverse transform: SCRAMBLED-layout input (big_fused_ntt's
    output), natural-order coefficients out, scaled by 1/n."""
    n, L = y.shape[-2], y.shape[-1]
    batch = y.shape[:-2]
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    w_inv = pow(w, -1, F.p)
    a = big_row_pass(F, y.reshape(nb * n1, n2, L).contiguous(),
                     pow(w_inv, n1, F.p), dif=False)
    a = F.mont_mul(a.reshape(nb, n1, n2, L).transpose(1, 2),
                   _tw_mid(F, w, n1, n2, True, y.device))
    a = big_row_pass(F, a.reshape(nb * n2, n1, L).contiguous(),
                     pow(w_inv, n2, F.p), dif=False, scale=pow(n, -1, F.p))
    return a.reshape(nb, n2, n1, L).transpose(1, 2).reshape(batch + (n, L))
