"""Sharded prefix product: the grand-product argument over a mesh.

Port of `plonk_tpu/parallel/dist_scan.py`. The prover's round-2
accumulator is a prefix product of per-row fractions. With the rows split
across the D shards of a mesh the scan becomes:

1. a local inclusive scan per shard,
2. an all-gather of the D shard totals,
3. a multiply by the product of all preceding shards' totals, folded in
   shard order.

On a CUDA mesh (`exchange` resolving to "cuda") the three steps are one
launch of K8 (`collectives.prefix_scan`), which exchanges the totals by
look-back between the shards' blocks and writes the grand product's
shifted form itself. With `exchange="plain"`, or shards on the CPU, they
run in PyTorch (`dist_scan_plain`: the local scans, `all_gather`, the
carries), which is also the kernel's oracle.

Exact in a field, so the result equals the sequential fold word for word.
"""
from __future__ import annotations

import torch

from ..models.plonk_scaled import _prefix_prod
from .collectives import all_gather, prefix_scan, resolve_exchange
from .mesh import Mesh, shard_vector, unshard_vector


def dist_scan_plain(F, mesh: Mesh, shards, shifted: bool = False):
    """dist_scan in PyTorch: the local scans, the all-gather of their
    totals (plain copies), the carries folded in shard order; with
    `shifted` the scan is joined, shifted right by one word behind a
    leading one and split again."""
    local = [_prefix_prod(F, x) for x in shards]
    totals = all_gather([loc[-1:] for loc in local], "plain")      # (D,)
    out = []
    for d, (loc, tot) in enumerate(zip(local, totals)):
        carry = F.ones((), loc.device)
        for i in range(d):
            carry = F.mul(carry, tot[i])
        out.append(F.mul(loc, carry))
    if shifted:
        scanned = unshard_vector(out)
        # shift right by one with a leading 1 (drop the final element)
        acc = torch.cat([F.ones((1,), scanned.device), scanned[..., :-1]])
        out = shard_vector(mesh, acc)
    return out, totals


def dist_scan(F, mesh: Mesh, shards, axis: str = "sp", exchange=None,
              shifted: bool = False):
    """(the inclusive prefix product of a sharded 1-D value, sharded the
    same way, or with `shifted` the accumulator form of
    dist_grand_product; the D shard totals as each shard gathers them)."""
    n_dev = mesh.shape[axis]
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    if resolve_exchange(exchange, shards[0].device) == "cuda":
        return prefix_scan(shards, F.p, F.n_prime, F.r_mod_p, shifted)
    return dist_scan_plain(F, mesh, shards, shifted)


def dist_prefix_prod(F, mesh: Mesh, shards, axis: str = "sp",
                     exchange=None):
    """Inclusive prefix product of a sharded 1-D value (same sharding
    out)."""
    return dist_scan(F, mesh, shards, axis, exchange)[0]


def dist_grand_product(F, mesh: Mesh, fractions, axis: str = "sp",
                       exchange=None):
    """The permutation accumulator [1, f0, f0*f1, ...] from sharded
    fractions of length n: the n-1 fractions padded with a trailing one so
    that the shards stay uniform. Returns the length-n accumulator
    [1, prefix products...], sharded the same way."""
    return dist_scan(F, mesh, fractions, axis, exchange, shifted=True)[0]
