"""K4: the fixed-base multi-commitment MSM over BN254 G1.

Port of `plonk_tpu/ops/pallas_bigmsm.py::big_commit_many_pallas` (TPU
kernel `_commit_kernel_v3`). `big_commit_many` launches the hand-written
kernel `csrc/big_commit.cu` on a CUDA tensor, reading the packed table of
`pack_commit_table` (built once per table: `models/plonk_bn254.py` caches
it beside the window table); `big_commit_many_plain` beside it is the same
sum in plain PyTorch over the int64 table (a gather of table[w][digit][i]
and a tree of complete additions), the CPU path and the kernel's test
oracle. Their Jacobian representatives differ; the affine points are
equal.

Both use the digits as the JAX wrapper makes them: window digits of the
standard-form scalar words, zeroed where the base point is infinity
(`pallas_bigmsm.py:678-679`); the plain version through `commit_digits`,
the kernel by reading each term's window from the scalar words itself.
Table entries with digit >= 1 must be real points, as in the JAX kernel
(true for any non-degenerate SRS).
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .bigcurve import (BigFixedBaseTable, BigG1J, affine_to_jac, big_digits,
                       big_tree_reduce)
from .bigfield import BigMontField

_THREADS = 128          # csrc/big_commit.cu THREADS
_BLOCKS_PER_SM = 4      # csrc/big_commit.cu MIN_BLOCKS
_JAC_WORDS = 24         # one Jacobian point: 3 x 8 32-bit limbs


def pack_commit_table(table: BigFixedBaseTable) -> torch.Tensor:
    """The window table as K4 reads it: (W, nb, L, 16) int32, the eight
    32-bit limbs of x then the eight of y of each entry (64 contiguous
    bytes), a quarter of the int64 words' bytes. Packed one window at a
    time through int64 arithmetic, wrapped to int32 at the end (the CPU
    has no uint32 `+`, `>>` or `>=`)."""
    W, nb, L, limbs = table.x.shape
    if limbs != 16 or table.y.shape != table.x.shape:
        raise ValueError("pack_commit_table: (W, nb, L, 16) tables expected")
    out = torch.empty((W, nb, L, 16), dtype=torch.int32,
                      device=table.x.device)
    for w in range(W):
        v = torch.cat([table.x[w, ..., 0::2] | (table.x[w, ..., 1::2] << 16),
                       table.y[w, ..., 0::2] | (table.y[w, ..., 1::2] << 16)],
                      dim=-1)
        out[w] = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return out


def unpack_commit_table(packed: torch.Tensor):
    """(x, y) int64 16-bit words of a packed table: pack_commit_table's
    inverse."""
    v = packed.to(torch.int64) & 0xFFFFFFFF
    words = torch.stack([v & 0xFFFF, v >> 16], dim=-1).flatten(-2)
    return words[..., :16], words[..., 16:]


def commit_digits(table: BigFixedBaseTable,
                  scalar_words: torch.Tensor) -> torch.Tensor:
    """(B, L, n_words) standard-form scalar words -> (B, W, L) int32
    window digits, zero where the base point (the d = 1 row of window 0)
    is infinity."""
    W, nb, L, _ = table.x.shape
    if scalar_words.dim() != 3 or scalar_words.shape[1] > L:
        raise ValueError(f"scalars must be (B, <= {L}, words), got "
                         f"{tuple(scalar_words.shape)}")
    if scalar_words.shape[1] < L:
        scalar_words = torch.nn.functional.pad(
            scalar_words, (0, 0, 0, L - scalar_words.shape[1]))
    digits = big_digits(scalar_words, int(table.window_bits), W)
    digits = torch.where(table.inf[0, 1][None, None, :], 0, digits)
    return digits.to(torch.int32).contiguous()


def big_commit_many_plain(F: BigMontField, table: BigFixedBaseTable,
                          scalar_words: torch.Tensor) -> BigG1J:
    """(B, L, n_words) standard-form scalar words -> (B,) Jacobian sums in
    plain PyTorch: gather every term, then halving levels of complete
    additions (run in slices where a level is wide)."""
    digits = commit_digits(table, scalar_words).long()     # (B, W, L)
    W, _, L, _ = table.x.shape
    dev = digits.device
    w = torch.arange(W, device=dev)[None, :, None]
    i = torch.arange(L, device=dev)[None, None, :]
    gx, gy, ginf = (table.x[w, digits, i], table.y[w, digits, i],
                    table.inf[w, digits, i])
    B = digits.shape[0]
    terms = affine_to_jac(F, gx.reshape(B, W * L, -1),
                          gy.reshape(B, W * L, -1), ginf.reshape(B, W * L))
    return big_tree_reduce(F, terms, dim=1)


def _tiles(n_terms: int, B: int, n_sm: int):
    """(tiles per commitment, terms per thread): about one resident wave of
    `_BLOCKS_PER_SM` blocks per SM over the B commitments."""
    per_b = max(1, n_sm * _BLOCKS_PER_SM // B)
    ppt = max(1, -(-n_terms // (_THREADS * per_b)))
    return -(-n_terms // (_THREADS * ppt)), ppt


def big_commit_many(F: BigMontField, table: BigFixedBaseTable,
                    scalar_words: torch.Tensor,
                    packed: torch.Tensor | None = None) -> BigG1J:
    """(B, L, n_words) standard-form scalar words -> (B,) Jacobian
    commitments against the window table. A CPU tensor takes the plain
    version (`packed` unused); a CUDA tensor launches K4 on `packed`, the
    table's `pack_commit_table`, or raises."""
    if scalar_words.device.type == "cpu":
        return big_commit_many_plain(F, table, scalar_words)
    dev = scalar_words.device
    if packed is None:
        raise ValueError("big_commit_many: K4 reads the packed table; pass "
                         "packed=pack_commit_table(table)")
    if dev.type != "cuda" or packed.device != dev \
            or table.inf.device != dev:
        raise ValueError("big_commit_many: scalars and tables must be on one "
                         "CUDA device")
    W, nb, L, limbs = table.x.shape
    if packed.dtype != torch.int32 or tuple(packed.shape) != (W, nb, L, 16) \
            or not packed.is_contiguous():
        raise ValueError(f"big_commit_many: packed table must be contiguous "
                         f"int32 ({W}, {nb}, {L}, 16)")
    if limbs != 16 or F.limbs != 16:
        raise ValueError("big_commit_many: (W, nb, L, 16) tables expected")
    wb = int(table.window_bits)
    if nb != 1 << wb:
        raise ValueError("big_commit_many: nb must be 2^window_bits")
    if scalar_words.dim() != 3 or scalar_words.shape[1] > L \
            or (W - 1) * wb >= 16 * scalar_words.shape[2]:
        raise ValueError(f"big_commit_many: scalars must be (B, <= {L}, "
                         f"> {(W - 1) * wb // 16} words), got "
                         f"{tuple(scalar_words.shape)}")
    B, Ls, NW = scalar_words.shape
    if B < 1:
        raise ValueError("big_commit_many: no scalars")
    scal = scalar_words.to(torch.int64).contiguous()
    base_inf = table.inf[0, 1].contiguous()
    n_tiles, ppt = _tiles(W * L, B,
                          torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    partials = torch.empty((B, n_tiles, _JAC_WORDS), dtype=torch.int32,
                           device=dev)
    out = torch.empty((3, B, 16), dtype=torch.int64, device=dev)
    err = kernels.library().big_commit_launch(
        scal.data_ptr(), base_inf.data_ptr(), Ls, NW, wb, packed.data_ptr(),
        B, W, nb, L,
        kernels.big_field_arg(F.p), kernels.u256_arg(F.R % F.p),
        partials.data_ptr(), n_tiles, ppt, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "big_commit")
    return BigG1J(out[0], out[1], out[2])
