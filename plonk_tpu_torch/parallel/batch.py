"""Multi-proof data parallelism: port of `plonk_tpu/parallel/batch.py`.

The circuit (selectors, copy constraints) is shared; witnesses,
challenges and blinding vary per proof. The JAX package maps `prove_core`
over the batch with `vmap` and shards the batch over a mesh axis with
pjit; here `prove_core` takes the leading batch dimension natively, and
the sharded prover proves each shard's slice of the batch on its device
of the single-controller mesh (parallel/mesh.py) and joins the slices.
"""
from __future__ import annotations

import torch

from ..models.plonk import PlonkContext, _words, prove_core
from .mesh import Mesh


def make_batched_prover(ctx: PlonkContext, selectors, copies):
    """fn(a_w, b_w, c_w, challenges, rands) -> (Proof, Diagnostics) over a
    leading batch axis of every argument: (B, n) wires, (B, 5) challenges,
    (B, 9) blinding; every output field has the leading B."""
    selectors = _words(selectors, ctx.device)
    copies = _words(copies, ctx.device)

    def run(a_w, b_w, c_w, challenges, rands):
        return prove_core(ctx, selectors, copies, a_w, b_w, c_w, challenges,
                          rands)

    return run


def _cat(parts):
    """Join per-shard outputs (tensors, points or tuples of them) along
    the batch axis."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    return type(first)(*(_cat([p[i] for p in parts])
                         for i in range(len(first))))


def make_sharded_prover(ctx: PlonkContext, selectors, copies, mesh: Mesh,
                        axis: str = "dp"):
    """The batched prover with the batch split over the mesh `axis`: shard
    d proves its slice of `torch.tensor_split(batch, D)` (any B; slices
    differ by at most one row, an empty one is skipped) on
    mesh.devices[d], one slice after another; the outputs are joined in
    shard order and equal the batched prover's."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
    if any(d != ctx.device for d in mesh.devices):
        raise ValueError(f"the mesh's devices {mesh.devices} are not the "
                         f"context's {ctx.device}")
    batched = make_batched_prover(ctx, selectors, copies)
    D = mesh.size

    def run(a_w, b_w, c_w, challenges, rands):
        args = [_words(x, ctx.device) for x in (a_w, b_w, c_w, challenges,
                                                rands)]
        shards = [torch.tensor_split(x, D, dim=0) for x in args]
        outs = [batched(*(s[d] for s in shards)) for d in range(D)
                if shards[0][d].shape[0]]
        proofs, diags = zip(*outs)
        return _cat(list(proofs)), _cat(list(diags))

    return run
