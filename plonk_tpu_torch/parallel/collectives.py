"""K8 and K9: the all-gather and the all-to-all of the sharded paths.

Port of `plonk_tpu/parallel/pallas_collectives.py` (TPU kernels
`_ring_kernel` and `_a2a_kernel`). A collective takes the D shards of a
sharded value (`parallel/mesh.py`) and returns D fresh tensors:

- `all_gather`: D tensors (rows, cols) or (rows,) -> D tensors
  (D*rows, cols) or (D*rows,), each the shards concatenated in order; the
  function of `gather_in_body` and of `lax.all_gather(..., tiled=True)`.
- `all_to_all(shards, split_axis, concat_axis)`: shard s's chunk j along
  `split_axis` goes to shard j, which concatenates the D chunks it
  receives in source order along `concat_axis`; the function of
  `all_to_all_in_body` and of `lax.all_to_all(..., tiled=True)`. The
  chunk reshuffle around the exchange is a PyTorch relayout, as JAX keeps
  it in XLA.

`exchange` picks how the bytes move: "cuda" launches the CUDA kernel
(`csrc/collectives.cu`, one launch for all D shards), "plain" runs
PyTorch copies (the counterpart of the `lax` collectives of JAX's
`exchange="xla"`), and None takes the kernel for shards on a CUDA device
and the plain copies for shards on the CPU. The TPU tile padding and the
interpret modes are not ported.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import kernels

MAX_SHARDS = 16                 # csrc/collectives.cu MAX_SHARDS


def resolve_exchange(exchange, device: torch.device) -> str:
    """"cuda" or "plain" for shards on `device`; None picks by device."""
    if exchange is None:
        return "cuda" if device.type == "cuda" else "plain"
    if exchange not in ("cuda", "plain"):
        raise ValueError(f"exchange must be 'cuda', 'plain' or None, got "
                         f"{exchange!r}")
    if exchange == "cuda" and device.type != "cuda":
        raise ValueError("exchange='cuda' needs shards on a CUDA device")
    return exchange


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_shards(name: str, srcs, dsts, src_chunks: int) -> int:
    """Preconditions of both exchanges: 1 <= D <= 16 contiguous sources of
    one size, each `src_chunks` chunks (K8: 1, K9: D), and D contiguous
    destinations of D chunks, one dtype, one device, no destination
    overlapping a source or another destination. Returns the chunk's size
    in bytes."""
    D = len(srcs)
    if not 1 <= D <= MAX_SHARDS or len(dsts) != D:
        raise ValueError(f"{name}: need 1..{MAX_SHARDS} sources and as many "
                         f"destinations, got {len(srcs)} and {len(dsts)}")
    shards = list(srcs) + list(dsts)
    dev, dtype = srcs[0].device, srcs[0].dtype
    if any(t.device != dev for t in shards):
        raise ValueError(f"{name}: all shards must be on one device")
    if any(t.dtype != dtype for t in shards):
        raise TypeError(f"{name}: shards differ in dtype")
    size = srcs[0].numel()
    chunk = size // src_chunks
    if size % src_chunks or any(t.numel() != size for t in srcs) or any(
            t.numel() != D * chunk for t in dsts):
        raise ValueError(f"{name}: {D} sources of {src_chunks} chunks and "
                         f"destinations of {D} chunks expected")
    if not all(t.is_contiguous() for t in shards):
        raise ValueError(f"{name}: shards must be contiguous")
    spans = [_span(t) for t in dsts]
    src_spans = [_span(t) for t in srcs]
    for i, (a0, a1) in enumerate(spans):
        for b0, b1 in src_spans + spans[:i]:
            if a0 < b1 and b0 < a1:
                raise ValueError(f"{name}: a destination overlaps a source "
                                 "or another destination")
    return chunk * srcs[0].element_size()


def _launch(name: str, srcs, dsts, chunk_bytes: int) -> None:
    """One launch of K8 (name "all_gather") or K9 ("all_to_all") over all
    D shards, copying in the widest unit that divides the chunk and every
    address."""
    if srcs[0].device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs shards on a CUDA device")
    if chunk_bytes == 0:
        return
    D = len(srcs)
    addrs = [t.data_ptr() for t in srcs + dsts]
    unit = 16
    while unit > 1 and (chunk_bytes % unit or any(a % unit for a in addrs)):
        unit //= 2
    src_arr = (ctypes.c_void_p * D)(*addrs[:D])
    dst_arr = (ctypes.c_void_p * D)(*addrs[D:])
    launch = getattr(kernels.library(), f"{name}_launch")
    err = launch(src_arr, dst_arr, D, chunk_bytes, unit,
                 torch.cuda.current_stream(srcs[0].device).cuda_stream)
    kernels.check_launch(err, name)


def all_gather_into_plain(srcs, dsts) -> None:
    """dsts[d] <- the sources concatenated in shard order, by PyTorch
    copies (one concatenation per destination)."""
    for dst in dsts:
        torch.cat([s.reshape(-1) for s in srcs], out=dst.view(-1))


def all_to_all_into_plain(srcs, dsts) -> None:
    """dsts[d] <- chunk d of every source, in source order, by PyTorch
    copies (one concatenation per destination)."""
    D = len(srcs)
    for d, dst in enumerate(dsts):
        torch.cat([s.reshape(D, -1)[d] for s in srcs], out=dst.view(-1))


def all_gather_into(srcs, dsts, exchange=None) -> None:
    """K8's function: D sources of one shape, D destinations of D times
    their size; destination d receives every source in shard order."""
    chunk_bytes = _check_shards("all_gather", srcs, dsts, 1)
    if resolve_exchange(exchange, srcs[0].device) == "plain":
        all_gather_into_plain(srcs, dsts)
    else:
        _launch("all_gather", list(srcs), list(dsts), chunk_bytes)


def all_to_all_into(srcs, dsts, exchange=None) -> None:
    """K9's function: D sources and D destinations of one size, each
    viewed as D chunks; chunk d of source s lands in chunk s of
    destination d."""
    chunk_bytes = _check_shards("all_to_all", srcs, dsts, len(srcs))
    if resolve_exchange(exchange, srcs[0].device) == "plain":
        all_to_all_into_plain(srcs, dsts)
    else:
        _launch("all_to_all", list(srcs), list(dsts), chunk_bytes)


def all_gather(shards, exchange=None) -> list[torch.Tensor]:
    """D shards (rows, cols) or (rows,) -> D fresh tensors (D*rows, cols)
    or (D*rows,), each the shards concatenated in order."""
    x = shards[0]
    if x.dim() not in (1, 2):
        raise ValueError("all_gather takes 1-D or 2-D shards")
    srcs = [s.contiguous() for s in shards]
    outs = [torch.empty((len(srcs) * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=s.device) for s in srcs]
    all_gather_into(srcs, outs, exchange)
    return outs


def all_to_all(shards, split_axis: int, concat_axis: int,
               exchange=None) -> list[torch.Tensor]:
    """Tiled all-to-all over D shards of one shape: shard s's chunk j along
    `split_axis` goes to shard j, which concatenates what it receives in
    source order along `concat_axis`. Returns D fresh tensors."""
    D = len(shards)
    x = shards[0]
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % D:
        raise ValueError("split axis must divide the mesh axis size")
    # -> (D, chunk) per shard with the split axis chunked and leading
    moved = [torch.movedim(s, split_axis, 0).reshape(D, -1).contiguous()
             for s in shards]
    got = [torch.empty_like(m) for m in moved]
    all_to_all_into(moved, got, exchange)
    # slot s of got[d] is source s's chunk for d in the moved layout:
    # restore the axis order per chunk, then concatenate the D chunks in
    # source order along concat_axis
    rest = tuple(torch.movedim(x, split_axis, 0).shape[1:])
    out = []
    for g in got:
        chunks = torch.movedim(g.reshape((D, x.shape[split_axis] // D) + rest),
                               1, split_axis + 1)
        out.append(torch.cat(list(chunks.unbind(0)), dim=concat_axis))
    return out
