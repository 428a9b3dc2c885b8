"""K1: all intra-row butterfly stages of the blocked NTT in one pass.

Port of `plonk_tpu/ops/pallas_ntt.py::row_stages` (TPU kernel
`_row_stages_kernel`). The CUDA kernel is `csrc/row_stages.cu`;
`row_stages_plain` beside it is the same function in plain PyTorch, the
CPU path and the kernel's test oracle.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .field import add_mod, mont_mul, sub_mod


def row_stages_plain(p: int, n_prime: int, y: torch.Tensor,
                     tw_stack: torch.Tensor) -> torch.Tensor:
    """All log2(C) DIT stages with distance < C on each row of y (R, C),
    partners reached by rolls along the row (the TPU kernel's lane rolls).
    tw_stack: (log2(C), C) per-stage lane twiddles (Montgomery form)."""
    C = y.shape[-1]
    pos = torch.arange(C, device=y.device)
    half = 1
    for s in range(tw_stack.shape[0]):
        tv = tw_stack[s]
        in_low = (pos % (2 * half)) < half
        down = torch.roll(y, -half, dims=-1)   # y[j + half] at position j
        up = torch.roll(y, half, dims=-1)      # y[j - half] at position j
        low_new = add_mod(y, mont_mul(down, tv, p, n_prime), p)
        high_new = sub_mod(up, mont_mul(y, tv, p, n_prime), p)
        y = torch.where(in_low, low_new, high_new)
        half *= 2
    return y


def row_stages(p: int, n_prime: int, y: torch.Tensor,
               tw_stack: torch.Tensor) -> torch.Tensor:
    """Apply all intra-row butterfly stages to y (R, C) in one pass.
    tw_stack: (log2(C), C) per-stage lane twiddles (Montgomery form).
    A CPU tensor takes the plain version; a CUDA tensor launches K1."""
    if y.device.type == "cpu":
        return row_stages_plain(p, n_prime, y, tw_stack)
    if y.device.type != "cuda" or tw_stack.device != y.device:
        raise ValueError("row_stages: y and tw_stack must be on one CUDA "
                         "device")
    if y.dtype != torch.int64 or tw_stack.dtype != torch.int64:
        raise TypeError("row_stages: int64 words expected")
    if y.dim() != 2 or not y.is_contiguous() \
            or not tw_stack.is_contiguous():
        raise ValueError("row_stages: y must be a contiguous (R, C) array")
    R, C = y.shape
    S = C.bit_length() - 1
    if C & (C - 1) or not 2 <= C <= 1024:
        raise ValueError(f"row_stages: C = {C} must be a power of two "
                         "in [2, 1024]")
    if tuple(tw_stack.shape) != (S, C):
        raise ValueError(f"row_stages: tw_stack must be ({S}, {C}), got "
                         f"{tuple(tw_stack.shape)}")
    out = torch.empty_like(y)
    if R == 0:
        return out
    lib = kernels.library()
    err = lib.row_stages_launch(
        y.data_ptr(), tw_stack.data_ptr(), out.data_ptr(), R, C, S, p,
        n_prime, torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(err, "row_stages")
    return out
