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
  `all_to_all_in_body` and of `lax.all_to_all(..., tiled=True)`. JAX keeps
  the relayout around the exchange in XLA because there the exchange
  crosses chips; on one card the relayout and the exchange are one copy:
  `a2a_plan` turns the shapes into a few strides and K9 moves every word
  once, from the shards as they are into the destinations' final layout.

On the sharded prover's path K8 runs inside `prefix_scan`: one launch of
`csrc/collectives.cu` computes the sharded prefix product of
`parallel/dist_scan.py` for all D shards, the all-gather of the shard
totals done by decoupled look-back between the shards' blocks; it returns
the gathered totals beside the scan, so K8's function stays checkable.
The plain version is `dist_scan`'s PyTorch code (local scans, `all_gather`,
the carries).

`exchange` picks how the bytes move: "cuda" launches the CUDA kernel
(`csrc/collectives.cu`, one launch for all D shards), "plain" runs
PyTorch copies (the counterpart of the `lax` collectives of JAX's
`exchange="xla"`; `all_to_all_plain` is the CPU path and K9's oracle), and
None takes the kernel for shards on a CUDA device and the plain copies for
shards on the CPU. The TPU tile padding and the interpret modes are not
ported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import kernels

MAX_SHARDS = 16                 # csrc/collectives.cu MAX_SHARDS
A2A_BATCH = 4                   # csrc/collectives.cu kBatch
SCAN_STATE_WORDS = 1 + MAX_SHARDS   # csrc/collectives.cu: ticket, flags


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


class Plan(NamedTuple):
    """How a collective moves its words, in elements: for every pair
    (source s, destination j) the same block of nb x nr rows of `run`
    contiguous elements, read from source s at j * src_pair + b * sb +
    r * sr and written to destination j at s * dst_pair + b * db + r * dr
    (b < nb, r < nr); each destination's shape."""
    nb: int
    nr: int
    run: int
    sb: int
    sr: int
    db: int
    dr: int
    src_pair: int
    dst_pair: int
    out_shape: tuple


def _row_major(shape) -> list:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return strides[::-1]


@functools.lru_cache(maxsize=256)
def a2a_plan(shape: tuple, D: int, split_axis: int,
             concat_axis: int) -> Plan:
    """K9's plan for D contiguous shards of `shape` (split and concat axes
    non-negative, the split axis a multiple of D). The block is a shard
    with the split axis cut to one chunk; its axes merge wherever both
    the source and the destination layout are contiguous across them. A
    source breaks contiguity only at the split axis and a destination
    only at the concat axis, so at most three axes remain: the batch, the
    rows and the innermost run (a run of one element when the innermost
    axis is not contiguous in both)."""
    c = shape[split_axis] // D
    block = list(shape)
    block[split_axis] = c
    out = list(shape)
    if split_axis != concat_axis:
        out[split_axis] = c
        out[concat_axis] = shape[concat_axis] * D
    ss, ds = _row_major(shape), _row_major(out)
    src_pair = c * ss[split_axis]
    dst_pair = (c if split_axis == concat_axis
                else shape[concat_axis]) * ds[concat_axis]
    if 0 in block:
        return Plan(0, 0, 0, 0, 0, 0, 0, src_pair, dst_pair, tuple(out))
    axes = []
    for n, a, b in zip(block, ss, ds):
        if n == 1:
            continue
        if axes and axes[-1][1] == n * a and axes[-1][2] == n * b:
            axes[-1] = (axes[-1][0] * n, a, b)
        else:
            axes.append((n, a, b))
    run = axes.pop() if axes and axes[-1][1:] == (1, 1) else (1, 1, 1)
    assert len(axes) <= 2, (shape, split_axis, concat_axis)
    (nb, sb, db), (nr, sr, dr) = [(1, 0, 0)] * (2 - len(axes)) + axes
    run = run[0]
    # a thread moves up to A2A_BATCH batch rows, its loads in flight
    # together: a lone run becomes rows of 64 elements, and without a
    # batch the rows fold into A2A_BATCH groups (fewer, fuller threads)
    if nb == nr == 1 and run > 64 and run % 64 == 0:
        nr, run, sr, dr = run // 64, 64, 64, 64
    if nb == 1 and nr % A2A_BATCH == 0:
        nb, nr = A2A_BATCH, nr // A2A_BATCH
        sb, db = nr * sr, nr * dr
    return Plan(nb, nr, run, sb, sr, db, dr, src_pair, dst_pair, tuple(out))


def _unit(values) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) dividing every
    value."""
    unit = 16
    while unit > 1 and any(v % unit for v in values):
        unit //= 2
    return unit


def _launch(name: str, srcs, dsts, plan: Plan) -> None:
    """One launch of K8 (name "all_gather", plan from `_gather_plan`) or
    K9 ("all_to_all") over all D shards, copying in the widest unit that
    divides the run, the strides and every address."""
    if srcs[0].device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs shards on a CUDA device")
    if plan.nb * plan.nr * plan.run == 0:
        return
    D = len(srcs)
    es = srcs[0].element_size()
    addrs = [t.data_ptr() for t in srcs + dsts]
    src_arr = (ctypes.c_void_p * D)(*addrs[:D])
    dst_arr = (ctypes.c_void_p * D)(*addrs[D:])
    stream = torch.cuda.current_stream(srcs[0].device).cuda_stream
    lib = kernels.library()
    if name == "all_gather":
        chunk_bytes = plan.run * es
        err = lib.all_gather_launch(src_arr, dst_arr, D, chunk_bytes,
                                    _unit(addrs + [chunk_bytes]), stream)
    else:
        lengths = [plan.run, plan.sb, plan.sr, plan.db, plan.dr,
                   plan.src_pair, plan.dst_pair]
        unit = _unit(addrs + [v * es for v in lengths])
        err = lib.all_to_all_launch(src_arr, dst_arr, D, plan.nb, plan.nr,
                                    *(v * es // unit for v in lengths), unit,
                                    stream)
    kernels.check_launch(err, name)


def _gather_plan(chunk: int) -> Plan:
    """K8's copy as a plan: source s whole into slot s of each
    destination."""
    return Plan(1, 1, chunk, 0, 0, 0, 0, 0, chunk, ())


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
        _launch("all_gather", list(srcs), list(dsts),
                _gather_plan(chunk_bytes // srcs[0].element_size()))


def all_to_all_into(srcs, dsts, exchange=None) -> None:
    """K9's function on contiguous chunks (the plan's simplest case): D
    sources and D destinations of one size, each viewed as D chunks;
    chunk d of source s lands in chunk s of destination d."""
    chunk_bytes = _check_shards("all_to_all", srcs, dsts, len(srcs))
    if resolve_exchange(exchange, srcs[0].device) == "plain":
        all_to_all_into_plain(srcs, dsts)
    else:
        D = len(srcs)
        _launch("all_to_all", list(srcs), list(dsts),
                a2a_plan((D * chunk_bytes // srcs[0].element_size(),), D, 0,
                         0))


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


def all_to_all_plain(shards, split_axis: int,
                     concat_axis: int) -> list[torch.Tensor]:
    """all_to_all by PyTorch copies, from its definition: destination j
    concatenates chunk j of every shard along concat_axis (one
    concatenation per destination)."""
    D = len(shards)
    chunks = [torch.chunk(s, D, dim=split_axis) for s in shards]
    return [torch.cat([c[j] for c in chunks], dim=concat_axis)
            for j in range(D)]


def all_to_all(shards, split_axis: int, concat_axis: int,
               exchange=None) -> list[torch.Tensor]:
    """Tiled all-to-all over D shards of one shape: shard s's chunk j along
    `split_axis` goes to shard j, which concatenates what it receives in
    source order along `concat_axis`. Returns D fresh tensors; through K9
    the D views of one allocation, written by one launch."""
    D = len(shards)
    x = shards[0]
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"all_to_all: need 1..{MAX_SHARDS} shards, got {D}")
    if x.shape[split_axis] % D:
        raise ValueError("split axis must divide the mesh axis size")
    if any(s.shape != x.shape for s in shards):
        raise ValueError("all_to_all: shards differ in shape")
    if any(s.device != x.device for s in shards):
        raise ValueError("all_to_all: all shards must be on one device")
    if any(s.dtype != x.dtype for s in shards):
        raise TypeError("all_to_all: shards differ in dtype")
    if resolve_exchange(exchange, x.device) == "plain":
        return all_to_all_plain(shards, split_axis, concat_axis)
    plan = a2a_plan(tuple(x.shape), D, split_axis, concat_axis)
    out = torch.empty((D,) + plan.out_shape, dtype=x.dtype, device=x.device)
    dsts = list(out.unbind(0))
    _launch("all_to_all", [s.contiguous() for s in shards], dsts, plan)
    return dsts


@functools.lru_cache(maxsize=None)
def _scan_state(device: torch.device, stream: int) -> torch.Tensor:
    """prefix_scan's ticket and shard flags for launches on `stream` of
    `device`: zero at first, then left by each launch ready for the next
    (the ticket moves to the next epoch, and each flag carries the epoch
    that wrote it). One a stream, so that launches that may overlap never
    share one."""
    return torch.zeros(SCAN_STATE_WORDS, dtype=torch.int64, device=device)


def prefix_scan(shards, p: int, n_prime: int, one: int,
                shifted: bool = False):
    """K8 on the prover's path: the sharded prefix product of D shards of
    m Montgomery words in [0, p) on one CUDA device, in one launch.
    Returns (D outputs, D gathered totals), each a list of views of one
    allocation: output d is shard d's inclusive scan times the product of
    the totals of shards 0 .. d-1 (its carry; `one` for shard 0), or with
    `shifted` the grand product's form (word 0 the carry, word j the scan
    at j - 1); totals d holds the D shard totals in shard order, the
    all-gather of the totals."""
    D = len(shards)
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"prefix_scan: need 1..{MAX_SHARDS} shards, got {D}")
    x = shards[0]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("prefix_scan: the kernel needs shards on a CUDA "
                         "device")
    if any(s.device != dev for s in shards):
        raise ValueError("prefix_scan: all shards must be on one device")
    if any(s.dtype != torch.int64 for s in shards):
        raise TypeError("prefix_scan: int64 words expected")
    m = x.shape[0] if x.dim() == 1 else 0
    if m < 1 or any(s.shape != (m,) for s in shards):
        raise ValueError("prefix_scan: D 1-D shards of one length >= 1 "
                         "expected")
    if not all(s.is_contiguous() for s in shards):
        raise ValueError("prefix_scan: shards must be contiguous")
    out = torch.empty((D, m), dtype=torch.int64, device=dev)
    totals = torch.empty((D, D), dtype=torch.int64, device=dev)
    outs = list(out.unbind(0))
    src_arr = (ctypes.c_void_p * D)(*[s.data_ptr() for s in shards])
    dst_arr = (ctypes.c_void_p * D)(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.library().prefix_scan_launch(
        src_arr, dst_arr, totals.data_ptr(),
        _scan_state(dev, stream).data_ptr(), D, m, int(shifted), p, n_prime,
        one, stream)
    kernels.check_launch(err, "all_gather")
    return outs, list(totals.unbind(0))
