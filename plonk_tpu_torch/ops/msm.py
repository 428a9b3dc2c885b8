"""Pippenger bucket-method multi-scalar multiplication.

Port of `plonk_tpu/ops/msm.py`, affine and Jacobian:
1. split the scalars into w-bit windows;
2. per window, sum the points into buckets by digit: sort by digit, then
   one segmented inclusive prefix sum (EC addition is associative, and
   the segment ends hold the bucket sums);
3. combine the buckets with the descending running sum;
4. combine the windows with w doublings each.

Every function takes leading batch dimensions on the scalars, (..., L)
against L shared points, where the JAX package maps over a batch with
`vmap`; all windows run at once along a window axis. The JAX package's
chunked scan of the Jacobian path (`_seg_scan_add_jac_chunked`) bounds
XLA's graph size; here one doubling scan serves both coordinate systems.
Affine outputs are canonical, so the points equal JAX's whatever order the
additions took; the Jacobian path converts to affine at the end.
"""
from __future__ import annotations

import torch

from .curve import (G1, G1J, g1_add, g1_double, jac_add, jac_double,
                    jac_from_affine, jac_to_affine)

I64 = torch.int64


def _map(pt, fn):
    """Apply fn to every coordinate of a point batch (G1 or G1J)."""
    return type(pt)(*(fn(c) for c in pt))


def _seg_scan(add, pts, starts: torch.Tensor):
    """Segmented inclusive prefix EC-sum along the last axis: inside each
    segment (a True in `starts` opens one) element i becomes the sum of
    the segment's elements up to i. log2(n) doubling steps."""
    n = starts.shape[-1]
    flag = starts
    k = 1
    while k < n:
        cur = _map(pts, lambda c: c[..., k:])
        s = add(_map(pts, lambda c: c[..., :-k]), cur)
        keep = flag[..., k:]
        pts = type(pts)(*(torch.cat([c[..., :k], torch.where(keep, b, a)],
                                    dim=-1)
                          for c, a, b in zip(pts, s, cur)))
        flag = torch.cat([flag[..., :k], flag[..., k:] | flag[..., :-k]],
                         dim=-1)
        k *= 2
    return pts


def _window_buckets(add, ident, pts, digits: torch.Tensor, n_buckets: int):
    """Bucket sums of one window per row of `digits` (..., L):
    bucket[..., b] = EC-sum of the points whose digit is b, shape
    (..., n_buckets); buckets that get no point hold `ident`'s point.
    Bucket 0 is unused by the caller."""
    order = torch.argsort(digits, dim=-1, stable=True)
    sd = torch.gather(digits, -1, order)
    sp = _map(pts, lambda c: torch.gather(c.expand(digits.shape), -1, order))
    ones = torch.ones(digits.shape[:-1] + (1,), dtype=torch.bool,
                      device=digits.device)
    starts = torch.cat([ones, sd[..., 1:] != sd[..., :-1]], dim=-1)
    scanned = _seg_scan(add, sp, starts)
    # segment ends hold the per-digit sums; other lanes write a spare slot
    is_end = torch.cat([sd[..., :-1] != sd[..., 1:], ones], dim=-1)
    write_idx = torch.where(is_end, sd, n_buckets)
    empty = ident(digits.shape[:-1] + (n_buckets + 1,))
    return type(pts)(*(e.scatter(-1, write_idx, s)[..., :n_buckets]
                       for e, s in zip(empty, scanned)))


def _bucket_reduce(add, ident, buckets):
    """sum_b b * bucket[..., b] by the descending running sum."""
    n_buckets = buckets[0].shape[-1]
    running = total = ident(buckets[0].shape[:-1])
    for b in range(n_buckets - 1, 0, -1):
        running = add(running, _map(buckets, lambda c: c[..., b]))
        total = add(total, running)
    return total


def _pippenger(add, double, ident, pts, scalars, window_bits: int,
               scalar_bits: int):
    scalars = torch.as_tensor(scalars, dtype=I64, device=pts[0].device)
    n_windows = -(-scalar_bits // window_bits)
    n_buckets = 1 << window_bits
    shifts = torch.arange(n_windows, device=scalars.device) * window_bits
    digits = (scalars[..., None, :] >> shifts[:, None]) & (n_buckets - 1)
    pts_w = _map(pts, lambda c: c[..., None, :])          # window axis
    buckets = _window_buckets(add, ident, pts_w, digits, n_buckets)
    wtot = _bucket_reduce(add, ident, buckets)             # (..., W)
    total = ident(wtot[0].shape[:-1])
    for wi in reversed(range(n_windows)):
        if wi != n_windows - 1:
            for _ in range(window_bits):
                total = double(total)
        total = add(total, _map(wtot, lambda c: c[..., wi]))
    return total


def msm_window_buckets(F, pts: G1, digits: torch.Tensor,
                       n_buckets: int) -> G1:
    """Affine bucket sums for one window: bucket[b] = EC-sum of the points
    whose digit is b, shape digits.shape[:-1] + (n_buckets,)."""
    return _window_buckets(lambda a, b: g1_add(F, a, b),
                           lambda s: G1.identity(s, digits.device),
                           pts, digits, n_buckets)


def msm_pippenger(F, pts: G1, scalars: torch.Tensor, window_bits: int = 5,
                  scalar_bits: int = 32) -> G1:
    """sum_i scalars[..., i] * pts[i] with affine buckets."""
    dev = pts.x.device
    return _pippenger(lambda a, b: g1_add(F, a, b),
                      lambda a: g1_double(F, a),
                      lambda s: G1.identity(s, dev), pts, scalars,
                      window_bits, scalar_bits)


def msm_pippenger_many(F, pts: G1, scalars_batch: torch.Tensor,
                       window_bits: int = 5, scalar_bits: int = 32) -> G1:
    """A (B, L) scalar matrix against shared points: B commitments."""
    return msm_pippenger(F, pts, scalars_batch, window_bits, scalar_bits)


def msm(F, pts: G1, scalars: torch.Tensor, window_bits: int = 5,
        scalar_bits: int = 32) -> G1:
    return msm_pippenger(F, pts, scalars, window_bits, scalar_bits)


def msm_pippenger_jac(F, pts: G1, scalars: torch.Tensor,
                      window_bits: int = 7, scalar_bits: int = 32) -> G1:
    """Pippenger with Jacobian buckets (no inversion an addition); returns
    affine points, equal to msm_pippenger's."""
    dev = pts.x.device
    total = _pippenger(lambda a, b: jac_add(F, a, b),
                       lambda a: jac_double(F, a),
                       lambda s: G1J.identity(F, s, dev),
                       jac_from_affine(F, pts), scalars, window_bits,
                       scalar_bits)
    return jac_to_affine(F, total)


def msm_pippenger_jac_many(F, pts: G1, scalars_batch: torch.Tensor,
                           window_bits: int = 7,
                           scalar_bits: int = 32) -> G1:
    return msm_pippenger_jac(F, pts, scalars_batch, window_bits,
                             scalar_bits)
