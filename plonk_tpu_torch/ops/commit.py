"""K2: the fixed-base multi-commitment MSM.

Port of `plonk_tpu/ops/pallas_msm.py` (TPU kernel `_commit_kernel`). The
CUDA kernel is `csrc/commit.cu`; `commit_many_plain` beside it is the same
sum in plain PyTorch (gathered terms + a Jacobian tree), the CPU path and
the kernel's test oracle. Jacobian representatives differ between the two;
their affine points are equal. K2 reads the table's packed copy
(`pack_commit_table`), which `build_commit_table` attaches to a table on
a CUDA device (`with_packed` to any other).
"""
from __future__ import annotations

import functools

import torch

from ..utils import kernels
from .curve import G1, G1J, jac_to_affine
from .fixed_base import FixedBaseTable, _gather_terms, _tree_reduce, \
    build_fixed_base_table

_THREADS = 256          # csrc/commit.cu kThreads
_MAX_WINDOWS = 8        # csrc/commit.cu kMaxWindows
# the packed x of an infinity entry: no coordinate below p < 2^31 takes it
INFINITY_X = 0xFFFFFFFF


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
    return with_packed(tbl)


def pack_commit_table(table: FixedBaseTable) -> torch.Tensor:
    """K2's copy of the table: (W, nb, L) int64 words x | y << 32
    (Montgomery form), an infinity entry x = INFINITY_X, y = 0."""
    x = torch.where(table.inf, INFINITY_X, table.x)
    y = torch.where(table.inf, 0, table.y)
    return (x | (y << 32)).contiguous()


def with_packed(table: FixedBaseTable) -> FixedBaseTable:
    """The table with its packed copy attached when it lies on a CUDA
    device (a CPU table is returned as it is: the plain version reads x, y
    and inf)."""
    if table.x.device.type != "cuda" or table.packed is not None:
        return table
    return table._replace(packed=pack_commit_table(table))


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """K2's last-block ticket for launches on `stream` of `device`: one
    word, 0 between launches (the kernel's last block resets it). One a
    stream, so that launches that may overlap never share one."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def commit_many_plain(F, table: FixedBaseTable,
                      scalars: torch.Tensor) -> G1J:
    """(B, L) standard-form scalars -> (B,) Jacobian sums in plain
    PyTorch."""
    return _tree_reduce(F, _gather_terms(F, table, scalars))


def commit_many(F, table: FixedBaseTable, scalars: torch.Tensor) -> G1J:
    """(B, L) standard-form scalars -> (B,) Jacobian commitments against the
    window table. A CPU tensor takes the plain version; a CUDA tensor
    launches K2, which reads the table's packed copy."""
    if scalars.device.type == "cpu":
        return commit_many_plain(F, table, scalars)
    dev = scalars.device
    packed = table.packed
    if packed is None:
        raise ValueError("commit_many: K2 reads the table's packed copy; "
                         "build the table with build_commit_table or attach "
                         "it with with_packed")
    if dev.type != "cuda" or packed.device != dev:
        raise ValueError("commit_many: scalars and table must be on one "
                         "CUDA device")
    if scalars.dtype != torch.int64 or packed.dtype != torch.int64:
        raise TypeError("commit_many: int64 scalars and packed table "
                        "expected")
    if not scalars.is_contiguous():
        raise ValueError("commit_many: scalars must be contiguous")
    W, nb, L = packed.shape
    wb = int(table.window_bits)
    if nb != 1 << wb or W * wb > 32 or W > _MAX_WINDOWS:
        raise ValueError(f"commit_many: need nb == 2^wb, W*wb <= 32 and at "
                         f"most {_MAX_WINDOWS} windows (W={W}, nb={nb}, "
                         f"wb={wb})")
    if scalars.dim() != 2 or scalars.shape[1] != L or scalars.shape[0] < 1:
        raise ValueError(f"commit_many: scalars must be (B >= 1, {L}), got "
                         f"{tuple(scalars.shape)}")
    B = scalars.shape[0]
    # point tiles: two blocks an SM while that leaves a thread 4 points or
    # more, else one; a tile has a thread's worth of points at least
    sms = _sm_count(dev)
    n_tiles = 2 * sms // B
    if L < 4 * _THREADS * n_tiles:
        n_tiles = sms // B
    n_tiles = max(1, min(n_tiles, -(-L // _THREADS)))
    partials = torch.empty((3, B, n_tiles), dtype=torch.int32, device=dev)
    out = torch.empty((3, B), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.library().commit_many_launch(
        scalars.data_ptr(), packed.data_ptr(), *packed.stride(), B, W, wb,
        L, F.p, F.n_prime, F.const(1), F.const(2), F.const(3), F.const(8),
        partials.data_ptr(), n_tiles, _ticket(dev, stream).data_ptr(),
        out.data_ptr(), stream)
    kernels.check_launch(err, "commit_many")
    return G1J(out[0], out[1], out[2])


def msm_fixed_base_many_kernel(F, table: FixedBaseTable,
                               scalars_batch: torch.Tensor) -> G1:
    """Batched commitments as affine points: commit_many + one batched
    affine conversion."""
    return jac_to_affine(F, commit_many(F, table, scalars_batch))
