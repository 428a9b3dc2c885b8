"""K2: the fixed-base multi-commitment MSM.

Port of `plonk_tpu/ops/pallas_msm.py` (TPU kernel `_commit_kernel`). The
CUDA kernel is `csrc/commit.cu`; `commit_many_plain` beside it is the same
sum in plain PyTorch (gathered terms + a Jacobian tree), the CPU path and
the kernel's test oracle. Jacobian representatives differ between the two;
their affine points are equal.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .curve import G1, G1J, jac_to_affine
from .fixed_base import FixedBaseTable, _gather_terms, _tree_reduce, \
    build_fixed_base_table

_THREADS = 256          # csrc/commit.cu THREADS
_POINTS_PER_THREAD = 4


def _pad_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def build_commit_table(F, pts: G1, scalar_bits: int,
                       window_bits: int = 4) -> FixedBaseTable:
    """Window table for the commit kernel: narrow windows, the window axis
    padded to a power of two with identity rows (x = y = 0, inf)."""
    tbl = build_fixed_base_table(F, pts, window_bits, scalar_bits)
    W = tbl.x.shape[0]
    Wp = _pad_pow2(W)
    if Wp != W:
        pad = (0, 0, 0, 0, 0, Wp - W)
        tbl = FixedBaseTable(
            x=torch.nn.functional.pad(tbl.x, pad),
            y=torch.nn.functional.pad(tbl.y, pad),
            inf=torch.nn.functional.pad(tbl.inf, pad, value=True),
            window_bits=window_bits)
    return tbl


def commit_many_plain(F, table: FixedBaseTable,
                      scalars: torch.Tensor) -> G1J:
    """(B, L) standard-form scalars -> (B,) Jacobian sums in plain
    PyTorch."""
    return _tree_reduce(F, _gather_terms(F, table, scalars))


def commit_many(F, table: FixedBaseTable, scalars: torch.Tensor) -> G1J:
    """(B, L) standard-form scalars -> (B,) Jacobian commitments against the
    window table. A CPU tensor takes the plain version; a CUDA tensor
    launches K2."""
    if scalars.device.type == "cpu":
        return commit_many_plain(F, table, scalars)
    dev = scalars.device
    if dev.type != "cuda" or any(t.device != dev for t in table[:3]):
        raise ValueError("commit_many: scalars and table must be on one "
                         "CUDA device")
    if (scalars.dtype != torch.int64 or table.x.dtype != torch.int64
            or table.y.dtype != torch.int64 or table.inf.dtype != torch.bool):
        raise TypeError("commit_many: int64 scalars/coordinates and a bool "
                        "inf mask expected")
    if not all(t.is_contiguous() for t in (scalars,) + tuple(table[:3])):
        raise ValueError("commit_many: inputs must be contiguous")
    W, nb, L = table.x.shape
    wb = int(table.window_bits)
    if table.y.shape != table.x.shape or table.inf.shape != table.x.shape:
        raise ValueError("commit_many: table arrays differ in shape")
    if nb != 1 << wb or W * wb > 32:
        raise ValueError(f"commit_many: need nb == 2^wb and W*wb <= 32 "
                         f"(W={W}, nb={nb}, wb={wb})")
    if scalars.dim() != 2 or scalars.shape[1] != L or scalars.shape[0] < 1:
        raise ValueError(f"commit_many: scalars must be (B >= 1, {L}), got "
                         f"{tuple(scalars.shape)}")
    B = scalars.shape[0]
    n_tiles = -(-L // (_THREADS * _POINTS_PER_THREAD))
    partials = torch.empty((3, B, n_tiles), dtype=torch.int32, device=dev)
    out = torch.empty((3, B), dtype=torch.int64, device=dev)
    lib = kernels.library()
    err = lib.commit_many_launch(
        scalars.data_ptr(), table.x.data_ptr(), table.y.data_ptr(),
        table.inf.data_ptr(), B, W, nb, L, wb, F.p, F.n_prime, F.const(1),
        F.const(2), F.const(3), F.const(8), partials.data_ptr(), n_tiles,
        _POINTS_PER_THREAD, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "commit_many")
    return G1J(out[0], out[1], out[2])


def msm_fixed_base_many_kernel(F, table: FixedBaseTable,
                               scalars_batch: torch.Tensor) -> G1:
    """Batched commitments as affine points: commit_many + one batched
    affine conversion."""
    return jac_to_affine(F, commit_many(F, table, scalars_batch))
