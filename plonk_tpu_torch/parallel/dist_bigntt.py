"""Sharded four-step NTT over 16-limb BN254 words.

Port of `plonk_tpu/parallel/dist_bigntt.py`, the limb lift of
`dist_ntt.py`: coefficients lie on axis -2 with the 16-bit-word axis
trailing (`ops/bigfield.py`), the domain is split across the D shards of a
mesh (`parallel/mesh.py`, a sharded value a list of D tensors batch +
(n/D, 16), `mesh.shard_rows`), and the only exchanges are the two matrix
transposes, each one `all_to_all` over the coefficient axes with the word
axis riding along (K9 on a CUDA mesh, plain copies on a CPU mesh). Same
decomposition and (k1, k2) transposed output layout as `dist_ntt.py`, so
its `transposed_perm` aligns natural-order tables to the output.

The local transforms run over the rows of all D shards together (they
share one device): on the CPU the port's `big_ntt`, as the JAX package's
body does; on a CUDA device one K3 launch a transform (`ops/bigntt.py`
`big_row_pass`, DIF from natural order, bit-reversed out) and one gather
back to natural order, the same words as `big_ntt`. A shape K3 does not
take raises; there is no fallback to the plain transform.

Twiddle blocks are made on the host with Python ints (254-bit products
overflow the uint64 arithmetic of `dist_ntt._twiddle_block`) and
Montgomery-encoded once per (p, w, split).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.bigfield import BigMontField, big_ntt, device_table
from ..ops.bigntt import big_row_pass
from ..ops.fused_ntt import _bitrev
from .collectives import all_to_all
from .dist_ntt import _split
from .mesh import Mesh


@functools.lru_cache(maxsize=None)
def _twiddle_words(p: int, w: int, n1: int, n2: int, n_dev: int,
                   inverse: bool, limbs: int) -> np.ndarray:
    """(n_dev, n1, n2/n_dev, limbs) Montgomery words of the twiddle blocks
    w^(+-i2*k1): block d holds rows k1 and columns i2 in [d*n2/n_dev, ...)
    (Python-int exponentiation, 254-bit safe)."""
    wq = pow(w, -1, p) if inverse else w
    cols = n2 // n_dev
    R = 1 << (16 * limbs)
    out = np.empty((n_dev, n1, cols, limbs), dtype=np.int64)
    for k1 in range(n1):
        base = pow(wq, k1, p)
        cur = 1
        for i2 in range(n2):
            m = cur * R % p
            out[i2 // cols, k1, i2 % cols] = [(m >> (16 * j)) & 0xFFFF
                                              for j in range(limbs)]
            cur = cur * base % p
    return out


def _row_ntt(F: BigMontField, x: torch.Tensor, w: int) -> torch.Tensor:
    """Size-C transforms with root w along axis -2 of x (..., C, 16),
    natural order in and out, through K3: one row pass over every row
    (DIF, bit-reversed out; the plain version on a CPU tensor), then one
    gather by the bit reversal."""
    C, L = x.shape[-2:]
    y = big_row_pass(F, x.reshape(-1, C, L).contiguous(), w, dif=True)
    return y[:, device_table(_bitrev, (C,), str(x.device)), :].reshape(
        x.shape)


def _local_ntt(F: BigMontField, x: torch.Tensor, w: int) -> torch.Tensor:
    """The local transforms along axis -2: big_ntt on the CPU, K3 through
    _row_ntt on a CUDA device."""
    if x.device.type == "cpu":
        return big_ntt(F, x, w)
    return _row_ntt(F, x, w)


def _cols_ntt(F: BigMontField, cols: torch.Tensor, w: int) -> torch.Tensor:
    """Transforms along axis -3 (the columns of a (..., n1, c, 16)
    block)."""
    return _local_ntt(F, cols.transpose(-3, -2), w).transpose(-3, -2)


def _geometry(mesh: Mesh, axis: str, shards) -> tuple:
    """(batch shape, n, limbs, n_dev) of a sharded value on `mesh`."""
    n_dev = mesh.shape[axis]
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    x = shards[0]
    return tuple(x.shape[:-2]), x.shape[-2] * n_dev, x.shape[-1], n_dev


def _twiddles(F: BigMontField, w: int, n1: int, n2: int, n_dev: int,
              inverse: bool, device, nb: int) -> torch.Tensor:
    """The twiddle blocks on `device`, shard axis first, broadcasting over
    nb batch axes."""
    tw = device_table(_twiddle_words, (F.p, w, n1, n2, n_dev, inverse,
                                       F.limbs), str(device))
    return tw.reshape((n_dev,) + (1,) * nb + tw.shape[1:])


def _exchange(shards: torch.Tensor, split_axis: int, concat_axis: int,
              exchange) -> torch.Tensor:
    """all_to_all over the shards of a stacked (D, ...) tensor, stacked
    again."""
    return torch.stack(all_to_all(list(shards.unbind(0)), split_axis,
                                  concat_axis, exchange))


def _unstack(x: torch.Tensor, batch: tuple, n_loc: int, L: int) -> list:
    return list(x.reshape((x.shape[0],) + batch + (n_loc, L)).unbind(0))


def dist_big_ntt(F: BigMontField, mesh: Mesh, shards, w: int,
                 axis: str = "sp", inverse: bool = False, exchange=None):
    """Forward (or unscaled-inverse) transform of a sharded value of shape
    batch + (n, limbs), sharded on the coefficient axis. Natural order in,
    (k1, k2) transposed layout out, sharded the same way."""
    batch, n, L, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    n1, n2 = _split(n, n_dev)
    wq = pow(w, -1, F.p) if inverse else w
    # 1. transpose -> batch + (n1, n2/n_dev, limbs) full columns a shard
    rows = [x.reshape(batch + (n1 // n_dev, n2, L)) for x in shards]
    cols = torch.stack(all_to_all(rows, nb + 1, nb, exchange))
    # 2. size-n1 transforms along the columns (root w^n2); 3. twiddle
    cols = F.mont_mul(_cols_ntt(F, cols, pow(wq, n2, F.p)),
                      _twiddles(F, w, n1, n2, n_dev, inverse, cols.device,
                                nb))
    # 4. transpose back -> batch + (n1/n_dev, n2, limbs) rows (k1 chunks)
    rows = _exchange(cols, nb, nb + 1, exchange)
    # 5. size-n2 transforms along the rows (root w^n1)
    return _unstack(_local_ntt(F, rows, pow(wq, n1, F.p)), batch,
                    n // n_dev, L)


def dist_big_intt(F: BigMontField, mesh: Mesh, shards, w: int,
                  axis: str = "sp", exchange=None):
    """Inverse of dist_big_ntt: (k1, k2) layout in, natural-order
    coefficients out, scaled by 1/n."""
    batch, n, L, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    n1, n2 = _split(n, n_dev)
    w_inv = pow(w, -1, F.p)
    # undo 5: inverse row transforms (root (w^n1)^-1, unscaled)
    rows = _local_ntt(F, torch.stack([
        y.reshape(batch + (n1 // n_dev, n2, L)) for y in shards]),
        pow(w_inv, n1, F.p))
    # undo 4: -> full columns; undo 3: inverse twiddle; undo 2
    cols = _exchange(rows, nb + 1, nb, exchange)
    cols = _cols_ntt(F, F.mont_mul(cols, _twiddles(
        F, w, n1, n2, n_dev, True, cols.device, nb)), pow(w_inv, n2, F.p))
    # undo 1: -> natural-order rows
    nat = _exchange(cols, nb, nb + 1, exchange)
    return _unstack(F.mont_mul(nat, F.const(pow(n, -1, F.p))), batch,
                    n // n_dev, L)


def _untranspose_big(F: BigMontField, mesh: Mesh, shards, n1: int, n2: int,
                     axis: str, exchange=None):
    """(k1, k2) layout -> natural order (one all_to_all and a local
    transpose)."""
    batch, n, L, n_dev = _geometry(mesh, axis, shards)
    nb = len(batch)
    rows = [y.reshape(batch + (n1 // n_dev, n2, L)) for y in shards]
    cols = all_to_all(rows, nb + 1, nb, exchange)
    return [c.transpose(-3, -2).reshape(batch + (n // n_dev, L))
            for c in cols]


def dist_big_interpolate(F: BigMontField, mesh: Mesh, values, w: int,
                         axis: str = "sp", exchange=None):
    """Natural-order INTT over limbs (the sharded interpolation)."""
    _, n, _, n_dev = _geometry(mesh, axis, values)
    n1, n2 = _split(n, n_dev)
    y = dist_big_ntt(F, mesh, values, w, axis, inverse=True,
                     exchange=exchange)
    nat = torch.stack(_untranspose_big(F, mesh, y, n1, n2, axis, exchange))
    return list(F.mont_mul(nat, F.const(pow(n, -1, F.p))).unbind(0))
