"""Mesh-sharded scaled prover: the sharded transforms, grand product and
commit wired into the 5-round pipeline.

Port of `plonk_tpu/parallel/dist_prover.py`. `make_dist_prims(ctx, mesh)`
builds a ProverPrims whose heavy steps run over the D shards of a mesh
(`parallel/mesh.py`):

- interpolations and the coset stack: the sharded four-step NTT
  (`dist_ntt`, its transposes K9 on a CUDA mesh); the coset transforms
  stay in the (k1, k2) transposed layout through the pointwise quotient
  algebra, and the coset-point table is permuted on the host to match;
- grand product: the sharded prefix scan (`dist_scan`: on a CUDA mesh
  one K8 launch that scans the shards, gathers their totals and writes
  the accumulator);
- commitments: the fixed-base window table split along its point axis,
  each shard's Jacobian partial sum over its slice (`ops/commit.py`: K2 on
  a CUDA mesh), the partials gathered and folded in shard order.

Field and curve arithmetic are exact, so `prove_scaled(...,
prims=make_dist_prims(ctx, mesh))` gives the same Proof as the
single-device prover, word for word. Each hook takes and returns whole
tensors, as the prover's other prims do; it splits them across the mesh
and joins the result.
"""
from __future__ import annotations

import torch

from ..models import plonk_scaled as PS
from ..ops import poly as Poly
from ..ops.commit import commit_many, with_packed
from ..ops.curve import G1, G1J, jac_add, jac_to_affine
from ..ops.fixed_base import FixedBaseTable
from . import dist_ntt as DN
from .dist_scan import dist_grand_product
from .mesh import Mesh, shard_vector, unshard_vector


def _pad_table(ctx, mesh: Mesh) -> list[FixedBaseTable]:
    """The context's window table with its point axis padded to a multiple
    of the mesh size by infinity entries (x = y = 0), stored as one
    contiguous table per shard with its packed copy for K2 on a CUDA
    device; cached on the context."""
    D = mesh.size
    key = f"_fb_table_shards{D}"
    shards = getattr(ctx, key, None)
    if shards is None:
        base = PS.fixed_base_table(ctx)
        L = base.x.shape[2]
        pad = (0, -(-L // D) * D - L)
        x = torch.nn.functional.pad(base.x, pad)
        y = torch.nn.functional.pad(base.y, pad)
        inf = torch.nn.functional.pad(base.inf, pad, value=True)
        shards = [with_packed(FixedBaseTable(
                      *(t.to(dev).contiguous() for t in parts),
                      window_bits=base.window_bits))
                  for dev, parts in zip(mesh.devices, zip(
                      *(torch.chunk(t, D, dim=-1) for t in (x, y, inf))))]
        object.__setattr__(ctx, key, shards)
    return shards


def dist_commit_many(ctx, mesh: Mesh, coeff_list, axis: str = "sp") -> G1:
    """Batched fixed-base commitments with the window table split across
    the mesh along its point axis: the same affine points as the
    single-device commit."""
    Fr, Fq = ctx.Fr, ctx.Fq
    tables = _pad_table(ctx, mesh)
    L = ctx.srs.length
    Lp = tables[0].x.shape[2] * mesh.shape[axis]
    padded = torch.stack([Poly.pad_to(c, Lp)[..., :Lp] for c in coeff_list])
    scalars = Fr.decode(padded)
    # padding lanes beyond the SRS length must contribute nothing
    scalars = scalars * (torch.arange(Lp, device=scalars.device) < L)
    parts = [commit_many(Fq, tbl, sc)
             for tbl, sc in zip(tables, shard_vector(mesh, scalars))]
    # the partials are gathered plainly (JAX uses lax.all_gather here
    # whatever its exchange) and folded in shard order
    tot = G1J.identity(Fq, (len(coeff_list),), scalars.device)
    for part in parts:
        tot = jac_add(Fq, tot, part)
    return jac_to_affine(Fq, tot)


def _batch_refused() -> ValueError:
    return ValueError("the mesh prims prove one proof at a time; batched "
                      "proving over a mesh is ROADMAP queue 1 item 10")


def make_dist_prims(ctx, mesh: Mesh, axis: str = "sp",
                    exchange=None) -> PS.ProverPrims:
    """ProverPrims running every heavy step sharded over `axis`. exchange:
    "cuda" (K8 and K9), "plain" (PyTorch copies) or None (the kernels on a
    CUDA mesh, the copies on a CPU mesh) for the NTT transposes and the
    grand-product totals; the proof is the same under each."""
    if mesh.device != ctx.device:
        raise ValueError(f"the mesh is on {mesh.device}, the context on "
                         f"{ctx.device}")
    n_dev = mesh.shape[axis]
    perm = DN.transposed_perm(ctx.domain8, n_dev)

    def sharded(fn):
        def transform(F, x, w):
            # a proof stacks at most its rows: (rows, n); a batch adds an
            # axis before them
            if x.dim() > 2:
                raise _batch_refused()
            return unshard_vector(fn(F, mesh, shard_vector(mesh, x), w,
                                     axis, exchange=exchange))
        return transform

    def grand_product(F, fractions):
        if fractions.dim() > 1:
            raise _batch_refused()
        padded = torch.cat([fractions, F.ones((1,), fractions.device)])
        return unshard_vector(dist_grand_product(
            F, mesh, shard_vector(mesh, padded), axis, exchange))

    return PS.ProverPrims(
        intt_n=sharded(DN.dist_interpolate),
        ntt8=sharded(DN.dist_ntt),
        intt8=sharded(DN.dist_intt),
        grand_product=grand_product,
        commit_many=lambda c, lst: dist_commit_many(c, mesh, lst, axis),
        perm8=lambda tbl: tbl[perm])
