"""Sharded four-step (Bailey) NTT over a mesh.

Port of `plonk_tpu/parallel/dist_ntt.py`. The evaluation domain is split
across the D shards of a mesh (`parallel/mesh.py`); butterflies are local
and the only exchanges are the matrix transposes, each one `all_to_all`
over all shards (`parallel/collectives.py`: K9 on a CUDA mesh).

Decomposition (n = n1 * n2, x in natural order, i = i1*n2 + i2,
k = k1 + n1*k2):

    X[k1 + n1 k2] = sum_{i2} w^{i2 k1} [ sum_{i1} x[i1, i2] (w^{n2})^{i1 k1} ]
                    * (w^{n1})^{i2 k2}

  1. all_to_all transpose -> columns local
  2. local size-n1 NTT (root w^{n2}) along i1
  3. twiddle w^{i2 k1}
  4. all_to_all transpose back -> rows local
  5. local size-n2 NTT (root w^{n1}) along i2

The forward transform leaves its result in the (k1, k2) "transposed"
layout (flat index j = k1*n2 + k2; `transposed_perm` maps natural-order
tables to it); the inverse consumes that layout and restores natural
order. `dist_interpolate` adds the one transpose that returns
natural-order coefficients.

Sharded values are lists of D tensors of shape batch + (n/D,): every
entry point takes and returns such a list, with any leading batch
dimensions. The local transforms are the port's `ops/ntt.ntt`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.ntt import ntt as local_ntt
from .collectives import all_to_all
from .mesh import Mesh


def _twiddle_block(Fp: int, w: int, n1: int, n2: int, d: int, n_dev: int,
                   inverse: bool) -> np.ndarray:
    """Host twiddle block w^{+-i2*k1} for shard d's column chunk: shape
    (n1, n2/n_dev), rows k1, columns i2 in [d*n2/n_dev, ...), standard
    form."""
    wq = pow(w, -1, Fp) if inverse else w
    cols = n2 // n_dev
    # row_pows[k1] = wq^{k1}; column c holds row_pows^{i2}, built by a
    # cumulative modular product in uint64 (p < 2^31 keeps products < 2^62)
    row_pows = np.empty(n1, dtype=np.uint64)
    cur = 1
    for r in range(n1):
        row_pows[r] = cur
        cur = (cur * wq) % Fp
    i2_start = d * cols
    col0 = np.array([pow(int(x), i2_start, Fp) for x in row_pows],
                    dtype=np.uint64)
    out = np.empty((n1, cols), dtype=np.uint32)
    acc = col0
    for c in range(cols):
        out[:, c] = acc
        acc = (acc * row_pows) % Fp
    return out


@functools.lru_cache(maxsize=None)
def _twiddle_all(Fp: int, w: int, n1: int, n2: int, n_dev: int,
                 inverse: bool) -> np.ndarray:
    """(n_dev, n1, n2/n_dev) stack of per-shard twiddle blocks."""
    return np.stack([_twiddle_block(Fp, w, n1, n2, d, n_dev, inverse)
                     for d in range(n_dev)])


@functools.lru_cache(maxsize=64)
def _twiddles_on(F, w: int, n1: int, n2: int, n_dev: int, inverse: bool,
                 device: torch.device) -> torch.Tensor:
    """The twiddle blocks in Montgomery form on `device` (the JAX package
    encodes them with F.array the same way)."""
    return F.array(_twiddle_all(F.p, w, n1, n2, n_dev, inverse).astype(
        np.int64), device)


def _split(n: int, n_dev: int):
    """Pick n1 (columns transform length) divisible by n_dev and n2 = n/n1,
    also divisible by n_dev, both powers of two."""
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    if n1 % n_dev or n2 % n_dev:
        n1 = max(n1, n_dev)
        n2 = n // n1
    if n1 % n_dev or n2 % n_dev or n1 * n2 != n:
        raise ValueError(f"cannot split n={n} across {n_dev} devices")
    return n1, n2


def transposed_perm(n: int, n_dev: int) -> np.ndarray:
    """Host permutation: perm[j] = natural index of the element the
    forward transform leaves at flat position j = k1*n2 + k2. Apply to a
    natural-order host table to align it with dist_ntt's output layout."""
    n1, n2 = _split(n, n_dev)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return (k1 + n1 * k2).reshape(-1)


def _geometry(mesh: Mesh, axis: str, shards) -> tuple:
    """(batch shape, n, n_dev) of a sharded value on `mesh`."""
    n_dev = mesh.shape[axis]
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    return tuple(shards[0].shape[:-1]), shards[0].shape[-1] * n_dev, n_dev


def _cols_ntt(F, cols: torch.Tensor, w: int) -> torch.Tensor:
    """Transform along axis -2 (the columns of a batch + (n1, c) block)."""
    return local_ntt(F, cols.transpose(-1, -2), w).transpose(-1, -2)


def dist_ntt(F, mesh: Mesh, shards, w: int, axis: str = "sp",
             inverse: bool = False, exchange=None):
    """Forward (or unscaled-inverse) transform of a sharded value of shape
    batch + (n,). Input natural order; output in the (k1, k2) transposed
    layout, sharded the same way."""
    batch, n, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    n1, n2 = _split(n, n_dev)
    wq = pow(w, -1, F.p) if inverse else w
    # 1. transpose: -> batch + (n1, n2/n_dev) full columns per shard
    rows = [x.reshape(batch + (n1 // n_dev, n2)) for x in shards]
    cols = all_to_all(rows, nb + 1, nb, exchange)
    # 2. local column transform, root w^{n2} of order n1; 3. twiddle
    tw = _twiddles_on(F, w, n1, n2, n_dev, inverse, shards[0].device)
    cols = [F.mul(_cols_ntt(F, c, pow(wq, n2, F.p)), tw[d])
            for d, c in enumerate(cols)]
    # 4. transpose back: -> batch + (n1/n_dev, n2) rows (k1 chunks)
    rows = all_to_all(cols, nb, nb + 1, exchange)
    # 5. local row transform, root w^{n1} of order n2
    return [local_ntt(F, r, pow(wq, n1, F.p)).reshape(
        batch + (n // n_dev,)) for r in rows]


def _untranspose(F, mesh: Mesh, shards, n1: int, n2: int, axis: str,
                 exchange=None):
    """(k1, k2) layout -> natural order k = k1 + n1*k2 (one all_to_all and
    a local transpose)."""
    batch, n, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    rows = [y.reshape(batch + (n1 // n_dev, n2)) for y in shards]
    cols = all_to_all(rows, nb + 1, nb, exchange)
    # natural order as (k2, k1) row-major: transpose locally
    return [c.transpose(-1, -2).reshape(batch + (n // n_dev,))
            for c in cols]


def _scale(F, shards, n: int):
    inv_n = F.const(pow(n, -1, F.p))
    return [F.mul(s, inv_n) for s in shards]


def dist_intt(F, mesh: Mesh, shards, w: int, axis: str = "sp",
              exchange=None):
    """Inverse of dist_ntt: input in (k1, k2) layout, output natural-order
    coefficients (scaled by 1/n). Runs the forward steps backwards with
    inverse roots and twiddles, so a forward, pointwise, inverse chain
    costs four all_to_alls."""
    batch, n, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    n1, n2 = _split(n, n_dev)
    w_inv = pow(w, -1, F.p)
    # undo step 5: inverse row transform (root (w^{n1})^{-1}, unscaled)
    rows = [local_ntt(F, y.reshape(batch + (n1 // n_dev, n2)),
                      pow(w_inv, n1, F.p)) for y in shards]
    # undo step 4: -> batch + (n1, n2/n_dev) full columns
    cols = all_to_all(rows, nb + 1, nb, exchange)
    # undo step 3: inverse twiddle; undo step 2: inverse column transform
    tw = _twiddles_on(F, w, n1, n2, n_dev, True, shards[0].device)
    cols = [_cols_ntt(F, F.mul(c, tw[d]), pow(w_inv, n2, F.p))
            for d, c in enumerate(cols)]
    # undo step 1: -> batch + (n1/n_dev, n2) natural-order rows
    nat = all_to_all(cols, nb, nb + 1, exchange)
    return _scale(F, [x.reshape(batch + (n // n_dev,)) for x in nat], n)


def dist_ntt_mul(F, mesh: Mesh, a, b, w: int, axis: str = "sp",
                 exchange=None):
    """Pointwise product in the transform domain; sharded inputs and
    output in natural order, length n (cyclic convolution: callers pad to
    avoid wraparound)."""
    fa = dist_ntt(F, mesh, a, w, axis, exchange=exchange)
    fb = dist_ntt(F, mesh, b, w, axis, exchange=exchange)
    return dist_intt(F, mesh, [F.mul(x, y) for x, y in zip(fa, fb)], w,
                     axis, exchange)


def dist_interpolate(F, mesh: Mesh, values, w: int, axis: str = "sp",
                     exchange=None):
    """Natural-order INTT (the sharded interpolate_at_h)."""
    batch, n, n_dev = _geometry(mesh, axis, values)
    n1, n2 = _split(n, n_dev)
    y = dist_ntt(F, mesh, values, w, axis, inverse=True, exchange=exchange)
    return _scale(F, _untranspose(F, mesh, y, n1, n2, axis, exchange), n)
