"""Sharded multi-scalar multiplication.

Port of `plonk_tpu/parallel/dist_msm.py`. The terms are split across the
mesh axis (data parallel over the MSM terms); each shard runs a local
Pippenger bucket pass, the shards' partial sums are all-gathered and every
shard folds them with EC additions in shard order (points do not reduce
with a sum of words).

On the single-controller mesh (`parallel/mesh.py`) the shards' local
passes are the lanes of one `msm_pippenger` call: the D shards' points and
scalars stacked (D, L/D), each lane its own MSM. Each partial (x, y and
the infinity flag) is packed into one int64 row, so the gather is one
`collectives.all_gather` of D (1, 3) rows: K8's generic all-gather, one
launch, on a CUDA mesh. The fold runs once, on the gathered rows, and its
point is the replicated output of the JAX package's `shard_map`.
"""
from __future__ import annotations

import torch

from ..ops.curve import G1, g1_add
from ..ops.msm import msm_pippenger
from .collectives import all_gather
from .mesh import Mesh, shard_vector

I64 = torch.int64


def dist_msm(F, mesh: Mesh, pts: G1, scalars, axis: str = "sp",
             window_bits: int = 5, scalar_bits: int = 32,
             exchange=None) -> G1:
    """sum_i scalars[i] * pts[i] with the L terms split along `axis` into
    mesh.size contiguous shards. `pts` is an (L,) point batch of F's
    words, `scalars` (L,) standard-form integers below 2^scalar_bits.
    exchange: "cuda" (K8), "plain" (PyTorch copies) or None (the kernel on
    a CUDA mesh, the copies on a CPU mesh) for the gather of the partials.
    Returns one G1 (0-d coordinates) on mesh.device. Raises ValueError when
    the mesh's axis is not `axis` or L does not split into mesh.size
    shards."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
    D = mesh.size
    L = pts.x.shape[-1]
    if pts.x.dim() != 1 or L % D:
        raise ValueError(f"{tuple(pts.x.shape)} terms do not split into {D} "
                         "shards")
    lanes = [torch.stack(shard_vector(mesh, t))
             for t in (pts.x, pts.y, pts.inf)]
    sc = torch.stack(shard_vector(mesh, torch.as_tensor(scalars, dtype=I64)))
    part = msm_pippenger(F, G1(*lanes), sc, window_bits=window_bits,
                         scalar_bits=scalar_bits)          # (D,)
    rows = torch.stack([part.x, part.y, part.inf.to(I64)], dim=-1)
    gathered = all_gather(list(rows[:, None].unbind(0)), exchange)[0]
    total = G1.identity((), mesh.device)
    for x, y, inf in gathered:
        total = g1_add(F, total, G1(x, y, inf.bool()))
    return total
