"""Mesh-sharded BN254 prover: the production-curve analog of
`parallel/dist_prover.py`.

Port of `plonk_tpu/parallel/dist_bn254.py`. `make_dist_bn254_prims(ctx,
mesh)` returns a `plonk_bn254.BN254Prims` whose heavy steps run over the D
shards of a mesh (`parallel/mesh.py`):

- the interpolations and the 4n coset transforms: the sharded 16-limb
  four-step NTT (`dist_bigntt.py`: transposes through K9 and local
  transforms through K3 on a CUDA mesh); the coset values stay in the
  (k1, k2) transposed layout, and perm4n aligns the coset-point table;
- the grand product: per-shard prefix products, the D shard totals
  gathered with `collectives.all_gather` (K8's generic all-gather on a
  CUDA mesh), the carries folded in shard order;
- the commitments: each shard's partial sum over its slice of the SRS
  points, the D partials reduced by the JAX package's halving tree, then
  to affine. The route follows `plonk_bn254.use_bn254_fixed_base`, as the
  single-device prims do: through the window table split along its point
  axis (K4 once a shard on a CUDA mesh), or without it as one batched
  Pippenger pass whose lanes are the shards' slices (the JAX package's
  route, whatever its switch).

Field and curve arithmetic are exact, so `prove_bn254(...,
prims=make_dist_bn254_prims(ctx, mesh))` gives the single-device proof
word for word. Each hook takes and returns whole tensors, as the other
prims do; it splits them across the mesh and joins the result. The mesh
prims prove one proof at a time: a leading batch axis raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..models import plonk_bn254 as PB
from ..ops import bigpoly as BPol
from ..ops.bigcommit import big_commit_many
from ..ops.bigcurve import (BigFixedBaseTable, BigG1J, affine_to_jac,
                            big_msm_pippenger_many, big_to_affine,
                            big_tree_reduce)
from ..ops.bigfield import BigMontField
from . import dist_bigntt as DBN
from .collectives import all_gather
from .dist_ntt import transposed_perm
from .dist_prover import _batch_refused
from .mesh import Mesh, shard_rows, unshard_rows


def dist_big_prefix_prod(F: BigMontField, mesh: Mesh, shards,
                         axis: str = "sp", exchange=None):
    """Inclusive prefix product of a sharded (n, limbs) value (sharded on
    the coefficient axis; the same sharding out): each shard's local scan
    (`bigpoly.prefix_prod_chunked`, all shards in one pass), the shard
    totals all-gathered, and each shard's carry, the product of the totals
    of the shards before it, folded in shard order as the JAX package's
    scan does. Exact, so equal to the sequential fold word for word."""
    n_dev = mesh.shape[axis]
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    local = BPol.prefix_prod_chunked(F, torch.stack(shards))  # (D, m, L)
    # row d: the D totals as shard d gathers them
    totals = torch.stack(all_gather(list(local[:, -1:].unbind(0)),
                                    exchange))
    dev = local.device
    carry = F.ones((n_dev,), dev)
    later = torch.arange(n_dev, device=dev)[:, None]
    for i in range(n_dev - 1):
        carry = torch.where(later > i, F.mont_mul(carry, totals[:, i]),
                            carry)
    return list(F.mont_mul(local, carry[:, None]).unbind(0))


def _check_device(ctx, mesh: Mesh) -> None:
    if mesh.device != ctx.device:
        raise ValueError(f"the mesh is on {mesh.device}, the context on "
                         f"{ctx.device}")


def _table_shards(ctx, mesh: Mesh) -> list:
    """The context's window table with its point axis padded to a multiple
    of the mesh size by infinity entries (x = y = 0), split into one table
    a shard, each with its slice of K4's packed table (None on the CPU):
    [(BigFixedBaseTable, packed)] cached on the context per shard count and
    window width."""
    D = mesh.size
    key = (D, PB.bn254_fb_window_bits())
    cache = ctx.__dict__.setdefault("_bn254_fb_table_shards", {})
    if key not in cache:
        base = PB.bn254_fixed_base_table(ctx)
        packed = PB.bn254_packed_table(ctx)
        L = base.x.shape[2]
        pad = -(-L // D) * D - L
        x, y = (TF.pad(t, (0, 0, 0, pad)) for t in (base.x, base.y))
        inf = TF.pad(base.inf, (0, pad), value=True)
        pk = None if packed is None else TF.pad(packed, (0, 0, 0, pad))
        c = (L + pad) // D
        cache[key] = [
            (BigFixedBaseTable(x[:, :, s], y[:, :, s],
                               inf[:, :, s].contiguous(), base.window_bits),
             None if pk is None else pk[:, :, s].contiguous())
            for s in (slice(d * c, (d + 1) * c) for d in range(D))]
    return cache[key]


def dist_big_commit_many(ctx, mesh: Mesh, coeff_list,
                         axis: str = "sp") -> PB.BigG1Affine:
    """The commitments of the k coefficient tensors (L_i, 16) of
    `coeff_list` with the SRS points split across the mesh, padded to
    Lp = ceil(L/D)*D with points at infinity whose scalars are zero: each
    shard's (k,) Jacobian partial sum over its slice, the D partials
    gathered (one device: stacked) and reduced by the JAX package's
    halving levels (acc[:h] + acc[h:]), then to affine; a BigG1Affine
    batch (k,) of Montgomery words, the single-device commit's points.
    The partials come from the window table's slices when
    use_bn254_fixed_base(ctx.device) holds (K4 once a shard on the card),
    else from one big_msm_pippenger_many with the JAX package's 8-bit
    windows whose D*k lanes are (shard, commitment) pairs, each over its
    shard's Lp/D points, so the windows are combined once for all
    shards."""
    _check_device(ctx, mesh)
    if any(c.dim() > 2 for c in coeff_list):
        raise _batch_refused()
    Fr, Fq = ctx.Fr, ctx.Fq
    D = mesh.shape[axis]
    L = ctx.srs.length
    Lp = -(-L // D) * D
    B = len(coeff_list)
    rows = torch.stack([BPol.pad_to(c, L)[..., :L, :] for c in coeff_list])
    scalars = shard_rows(mesh, TF.pad(Fr.decode(rows), (0, 0, 0, Lp - L)))
    if PB.use_bn254_fixed_base(ctx.device):
        parts = [big_commit_many(Fq, tbl, sc, pk) for (tbl, pk), sc in
                 zip(_table_shards(ctx, mesh), scalars)]
        acc = BigG1J(*(torch.stack(c) for c in zip(*parts)))    # (D, k)
    else:
        g = ctx.srs.g1s
        pts = affine_to_jac(Fq, g.x, g.y, g.inf)
        pad = BigG1J.identity(Fq, (Lp - L,), ctx.device)
        lanes = lambda c: torch.stack(shard_rows(mesh, c))[:, None].expand(
            D, B, Lp // D, Fq.limbs).reshape(D * B, Lp // D, Fq.limbs)
        part = big_msm_pippenger_many(
            Fq, BigG1J(*(lanes(torch.cat([a, b])) for a, b in zip(pts, pad))),
            torch.stack(scalars).reshape(D * B, Lp // D, Fr.limbs),
            window_bits=PB.MSM_WINDOW_BITS, scalar_bits=PB.FR_BITS)
        acc = BigG1J(*(c.reshape(D, B, Fq.limbs) for c in part))
    return PB.BigG1Affine(*big_to_affine(Fq, big_tree_reduce(Fq, acc, 0)))


def make_dist_bn254_prims(ctx, mesh: Mesh, axis: str = "sp",
                          exchange=None) -> PB.BN254Prims:
    """BN254Prims running every heavy step sharded over `axis`. exchange:
    "cuda" (K8 and K9), "plain" (PyTorch copies) or None (the kernels on a
    CUDA mesh, the copies on a CPU mesh) for the NTT transposes and the
    grand product's totals; the proof is the same under each. The mesh
    must be on the context's device, and a proof batch raises
    ValueError."""
    _check_device(ctx, mesh)
    n_dev = mesh.shape[axis]
    perm = torch.as_tensor(transposed_perm(4 * ctx.n, n_dev),
                           device=ctx.device)

    def sharded(fn, w):
        def transform(F, x):
            # a proof stacks at most its rows: (rows, n, 16); a batch adds
            # an axis before them
            if x.dim() > 3:
                raise _batch_refused()
            return unshard_rows(fn(F, mesh, shard_rows(mesh, x), w, axis,
                                   exchange=exchange))
        return transform

    def grand_product(F, fractions):
        if fractions.dim() > 2:
            raise _batch_refused()
        one = F.ones((1,), fractions.device)
        scanned = unshard_rows(dist_big_prefix_prod(
            F, mesh, shard_rows(mesh, torch.cat([fractions, one])), axis,
            exchange))
        return torch.cat([one, scanned[:-1]])

    return PB.BN254Prims(
        intt_n=sharded(DBN.dist_big_interpolate, ctx.omega),
        ntt4n=sharded(DBN.dist_big_ntt, ctx.omega4),
        intt4n=sharded(DBN.dist_big_intt, ctx.omega4),
        grand_product=grand_product,
        commit_many=lambda coeff_list: dist_big_commit_many(
            ctx, mesh, coeff_list, axis),
        perm4n=lambda tbl: tbl[perm])
