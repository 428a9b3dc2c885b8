"""The single-controller device mesh of the sharded paths.

Port of `plonk_tpu/parallel/mesh.py`. The model is that of JAX's
`shard_map`, run from one host thread:
- a `Mesh` is one named axis over a list of shard devices;
- a sharded value is a list of D tensors, one per shard, split along the
  last axis (`shard_vector`, joined again by `unshard_vector`), or for
  16-limb BN254 values (..., n, 16) along the coefficient axis -2
  (`shard_rows`, `unshard_rows`);
- a body runs once per shard, in shard order;
- a collective (`parallel/collectives.py`) is one call that takes all D
  shards.

Several shards may share one device, as the JAX package's tests put eight
virtual CPU devices on one host: `make_1d_mesh("sp", 8)` puts eight
shards on the CUDA card, `make_1d_mesh("sp", 4, device="cpu")` four on
the CPU. A mesh over two or more different CUDA devices needs peer access
and cross-device stream ordering that the collectives do not have yet, and
raises.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.kernels import resolve_device


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index, as the tensors on it report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis `axis` over `devices`, one entry per shard."""
    axis: str
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if len(set(devs)) > 1:
            if all(d.type == "cuda" for d in devs):
                raise NotImplementedError(
                    "a mesh over several CUDA devices is not supported yet "
                    "(ROADMAP queue 1 item 10: peer copies and stream "
                    "ordering across cards)")
            raise ValueError("the shards of a mesh must share one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """{axis: number of shards}, as `jax.sharding.Mesh.shape`."""
        return {self.axis: self.size}

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_1d_mesh(axis: str = "sp", n: int = 1, device=None) -> Mesh:
    """n shards on one device: `device` when given, else the CUDA card."""
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(axis, (resolve_device(device),) * n)


def shard_vector(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Split `x` along its last axis into mesh.size equal contiguous
    shards, shard d on mesh.devices[d]."""
    D = mesh.size
    if x.shape[-1] % D:
        raise ValueError(f"last axis {x.shape[-1]} does not split into {D} "
                         "shards")
    return [s.to(dev).contiguous()
            for s, dev in zip(torch.chunk(x, D, dim=-1), mesh.devices)]


def unshard_vector(shards: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of shard_vector: the shards joined along the last
    axis."""
    return torch.cat(shards, dim=-1)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Split `x` along axis -2 (the coefficient axis of (..., n, 16)
    BN254 words) into mesh.size equal contiguous shards, shard d on
    mesh.devices[d]."""
    D = mesh.size
    if x.dim() < 2 or x.shape[-2] % D:
        raise ValueError(f"axis -2 of {tuple(x.shape)} does not split into "
                         f"{D} shards")
    return [s.to(dev).contiguous()
            for s, dev in zip(torch.chunk(x, D, dim=-2), mesh.devices)]


def unshard_rows(shards: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of shard_rows: the shards joined along axis -2."""
    return torch.cat(shards, dim=-2)
