"""K1 and K5: butterfly stages along the rows of a (R, C) array, one pass.

K1 `row_stages` ports `plonk_tpu/ops/pallas_ntt.py::row_stages` (TPU
kernel `_row_stages_kernel`): the intra-row DIT stages of the blocked NTT.
K5 `row_transform` ports `row_transform` (TPU kernel `_full_row_kernel`):
one complete size-C transform per row, DIF (natural -> bit-reversed) or
DIT (bit-reversed -> natural), the row pass of `ops/fused_ntt.fused_ntt`.
K1's stages are K5's DIT, so both run the CUDA kernel of
`csrc/row_stages.cu`, templated on the direction; `row_stages_plain` and
`row_transform_plain` beside them are the same functions in plain
PyTorch, the CPU path and the kernels' test oracles. The kernel reads the
compact form of the lane-periodic stage table (`compact_twiddles`), made
once per table.
"""
from __future__ import annotations

import functools

import torch

from ..utils import kernels
from .field import add_mod, mont_mul, sub_mod


def row_stages_plain(p: int, n_prime: int, y: torch.Tensor,
                     tw_stack: torch.Tensor) -> torch.Tensor:
    """All log2(C) DIT stages with distance < C on each row of y (R, C),
    partners reached by rolls along the row (the TPU kernel's lane rolls).
    tw_stack: (log2(C), C) per-stage lane twiddles (Montgomery form)."""
    return row_transform_plain(p, n_prime, y, tw_stack, dif=False)


def row_transform_plain(p: int, n_prime: int, y: torch.Tensor,
                        tw_stack: torch.Tensor, dif: bool) -> torch.Tensor:
    """One full size-C transform along the last axis of y, partners reached
    by rolls: DIF stages half = C/2 .. 1 with (a + b, (a - b) * tw), or DIT
    stages half = 1 .. C/2 with (a + b * tw, a - b * tw). tw_stack:
    (log2(C), C) per-stage lane twiddles (Montgomery form)."""
    C = y.shape[-1]
    pos = torch.arange(C, device=y.device)
    S = tw_stack.shape[0]
    for s in (reversed(range(S)) if dif else range(S)):
        half = 1 << s
        tv = tw_stack[s]
        in_low = (pos % (2 * half)) < half
        down = torch.roll(y, -half, dims=-1)   # y[j + half] at position j
        up = torch.roll(y, half, dims=-1)      # y[j - half] at position j
        if dif:
            low_new = add_mod(y, down, p)
            high_new = mont_mul(sub_mod(up, y, p), tv, p, n_prime)
        else:
            low_new = add_mod(y, mont_mul(down, tv, p, n_prime), p)
            high_new = sub_mod(up, mont_mul(y, tv, p, n_prime), p)
        y = torch.where(in_low, low_new, high_new)
    return y


def _check_rows(name: str, y: torch.Tensor, tw_stack: torch.Tensor) -> None:
    """The kernels' preconditions: contiguous int64 (R, C) rows and their
    (log2 C, C) table on one CUDA device, C a power of two in [2, 1024]."""
    if y.device.type != "cuda" or tw_stack.device != y.device:
        raise ValueError(f"{name}: y and tw_stack must be on one CUDA device")
    if y.dtype != torch.int64 or tw_stack.dtype != torch.int64:
        raise TypeError(f"{name}: int64 words expected")
    if y.dim() != 2 or not y.is_contiguous() \
            or not tw_stack.is_contiguous():
        raise ValueError(f"{name}: y must be a contiguous (R, C) array")
    C = y.shape[1]
    S = C.bit_length() - 1
    if C & (C - 1) or not 2 <= C <= 1024:
        raise ValueError(f"{name}: C = {C} must be a power of two in "
                         "[2, 1024]")
    if tuple(tw_stack.shape) != (S, C):
        raise ValueError(f"{name}: tw_stack must be ({S}, {C}), got "
                         f"{tuple(tw_stack.shape)}")


@functools.lru_cache(maxsize=64)
def compact_twiddles(tw_stack: torch.Tensor) -> torch.Tensor:
    """K1's and K5's table: the C - 1 distinct words of a lane-periodic
    (log2 C, C) stage table, stage s's 2^s values at offset 2^s - 1, as
    int32 (uint32 in the kernel). Refuses a table whose stage s is not periodic in 2^s
    (tw[s][j] == tw[s][j mod 2^s]), the form that lets both lanes of a pair
    share one product. Made once per table, which is keyed by the tensor
    object itself: a table must not change after its first use."""
    S, C = tw_stack.shape
    parts = []
    for s in range(S):
        head = tw_stack[s, :1 << s]
        if not torch.equal(tw_stack[s], head.repeat(C >> s)):
            raise ValueError(f"stage {s} of the twiddle table is not "
                             f"periodic in 2^{s}")
        parts.append(head)
    return torch.cat(parts).to(torch.int32)


def _launch(name: str, p: int, n_prime: int, y: torch.Tensor,
            tw_stack: torch.Tensor, dif: bool) -> torch.Tensor:
    """One launch of csrc/row_stages.cu on the rows of y, counted under
    `name` ("row_stages" for K1, "row_transform" for K5)."""
    _check_rows(name, y, tw_stack)
    if p >= 1 << 30:
        raise ValueError(f"{name}: the kernel's lazy residues need p < 2^30")
    R, C = y.shape
    out = torch.empty_like(y)
    if R == 0:
        return out
    err = kernels.library().row_stages_launch(
        y.data_ptr(), compact_twiddles(tw_stack).data_ptr(), out.data_ptr(),
        R, C.bit_length() - 1, int(dif), p, n_prime,
        torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check_launch(err, name)
    return out


def row_stages(p: int, n_prime: int, y: torch.Tensor,
               tw_stack: torch.Tensor) -> torch.Tensor:
    """Apply all intra-row butterfly stages to y (R, C) in one pass.
    tw_stack: (log2(C), C) per-stage lane twiddles (Montgomery form).
    A CPU tensor takes the plain version; a CUDA tensor launches K1, which
    takes lane-periodic tables only (those of ops/ntt.py) and p < 2^30."""
    if y.device.type == "cpu":
        return row_stages_plain(p, n_prime, y, tw_stack)
    return _launch("row_stages", p, n_prime, y, tw_stack, False)


def row_transform(p: int, n_prime: int, y: torch.Tensor,
                  tw_stack: torch.Tensor, dif: bool) -> torch.Tensor:
    """One complete size-C transform per row of y (R, C): dif=True natural
    -> bit-reversed, dif=False bit-reversed -> natural. tw_stack as made by
    ops/ntt._stage_tables for n = C (Montgomery form). A CPU tensor takes
    the plain version; a CUDA tensor launches K5, which takes lane-periodic
    tables only (those of ops/fused_ntt.py) and p < 2^30."""
    if y.device.type == "cpu":
        return row_transform_plain(p, n_prime, y, tw_stack, dif)
    return _launch("row_transform", p, n_prime, y, tw_stack, dif)
