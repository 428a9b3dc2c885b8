"""Sharded prefix product: the grand-product argument over a mesh.

Port of `plonk_tpu/parallel/dist_scan.py`. The prover's round-2
accumulator is a prefix product of per-row fractions. With the rows split
across the D shards of a mesh the scan becomes:

1. a local inclusive scan per shard,
2. an all-gather of the D shard totals (`collectives.all_gather`: K8 on
   a CUDA mesh),
3. a multiply by the product of all preceding shards' totals, folded in
   shard order.

Exact in a field, so the result equals the sequential fold word for word.
"""
from __future__ import annotations

import torch

from ..models.plonk_scaled import _prefix_prod
from .collectives import all_gather
from .mesh import Mesh, shard_vector, unshard_vector


def dist_prefix_prod(F, mesh: Mesh, shards, axis: str = "sp",
                     exchange=None):
    """Inclusive prefix product of a sharded 1-D value (same sharding
    out)."""
    n_dev = mesh.shape[axis]
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    local = [_prefix_prod(F, x) for x in shards]
    totals = all_gather([loc[-1:] for loc in local], exchange)     # (D,)
    out = []
    for d, (loc, tot) in enumerate(zip(local, totals)):
        carry = F.ones((), loc.device)
        for i in range(d):
            carry = F.mul(carry, tot[i])
        out.append(F.mul(loc, carry))
    return out


def dist_grand_product(F, mesh: Mesh, fractions, axis: str = "sp",
                       exchange=None):
    """The permutation accumulator [1, f0, f0*f1, ...] from sharded
    fractions of length n: the n-1 fractions padded with a trailing one so
    that the shards stay uniform. Returns the length-n accumulator
    [1, prefix products...], sharded the same way."""
    scanned = unshard_vector(dist_prefix_prod(F, mesh, fractions, axis,
                                              exchange))
    # shift right by one with a leading 1 (drop the final element)
    acc = torch.cat([F.ones((1,), scanned.device), scanned[..., :-1]])
    return shard_vector(mesh, acc)
