"""K4: the fixed-base multi-commitment MSM over BN254 G1.

Port of `plonk_tpu/ops/pallas_bigmsm.py::big_commit_many_pallas` (TPU
kernel `_commit_kernel_v3`). `big_commit_many` launches the hand-written
kernel `csrc/big_commit.cu` on a CUDA tensor; `big_commit_many_plain`
beside it is the same sum in plain PyTorch (a gather of
table[w][digit][i] and a tree of complete additions), the CPU path and the
kernel's test oracle. Their Jacobian representatives differ; the affine
points are equal.

Both take the digits as the JAX wrapper makes them: window digits of the
standard-form scalar words, zeroed where the base point is infinity
(`pallas_bigmsm.py:678-679`). Table entries with digit >= 1 must be real
points, as in the JAX kernel (true for any non-degenerate SRS).
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .bigcurve import (BigFixedBaseTable, BigG1J, _big_digits_batch,
                       affine_to_jac, big_tree_reduce)
from .bigfield import BigMontField

_THREADS = 128          # csrc/big_commit.cu THREADS
_TERMS_PER_THREAD = 16
_JAC_WORDS = 24         # one Jacobian point: 3 x 8 32-bit limbs


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
    digits = _big_digits_batch(scalar_words, int(table.window_bits), W,
                               scalar_words.shape[-1])
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


def big_commit_many(F: BigMontField, table: BigFixedBaseTable,
                    scalar_words: torch.Tensor) -> BigG1J:
    """(B, L, n_words) standard-form scalar words -> (B,) Jacobian
    commitments against the window table. A CPU tensor takes the plain
    version; a CUDA tensor launches K4 or raises."""
    if scalar_words.device.type == "cpu":
        return big_commit_many_plain(F, table, scalar_words)
    dev = scalar_words.device
    if dev.type != "cuda" or any(t.device != dev for t in table[:3]):
        raise ValueError("big_commit_many: scalars and table must be on one "
                         "CUDA device")
    if table.x.dtype != torch.int64 or table.y.dtype != torch.int64:
        raise TypeError("big_commit_many: int64 table words expected")
    W, nb, L, limbs = table.x.shape
    if limbs != 16 or F.limbs != 16 or table.y.shape != table.x.shape:
        raise ValueError("big_commit_many: (W, nb, L, 16) tables expected")
    if not (table.x.is_contiguous() and table.y.is_contiguous()):
        raise ValueError("big_commit_many: the table must be contiguous")
    if nb != 1 << int(table.window_bits):
        raise ValueError("big_commit_many: nb must be 2^window_bits")
    digits = commit_digits(table, scalar_words)
    B = digits.shape[0]
    if B < 1:
        raise ValueError("big_commit_many: no scalars")
    n_tiles = -(-(W * L) // (_THREADS * _TERMS_PER_THREAD))
    partials = torch.empty((B, n_tiles, _JAC_WORDS), dtype=torch.int32,
                           device=dev)
    out = torch.empty((3, B, 16), dtype=torch.int64, device=dev)
    err = kernels.library().big_commit_launch(
        digits.data_ptr(), table.x.data_ptr(), table.y.data_ptr(), B, W, nb,
        L, kernels.big_field_arg(F.p), kernels.u256_arg(F.R % F.p),
        partials.data_ptr(), n_tiles, _TERMS_PER_THREAD, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "big_commit")
    return BigG1J(out[0], out[1], out[2])
