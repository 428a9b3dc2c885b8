"""Tracing, timing and metric lines.

Port of `plonk_tpu/utils/profiling.py`:
- `round_scope`: a named `torch.profiler.record_function` region, so a
  prover round shows up by name in a trace;
- `trace_to`: a `torch.profiler` run over the enclosed block, CPU and
  (when torch sees a card) CUDA activity, written as a Chrome trace into
  a directory; `device_events` reads a written trace's device events (the
  card's torch 2.11 has no `_KinetoEvent.activity_type`, so the events
  are read from the file, not from the profiler object);
- `Timer`, `timeit`, `throughput`: wall-clock helpers, `timeit`
  synchronising the devices of its output's tensors;
- `metrics_line`: the one-line JSON metric record of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import torch

DEVICE_EVENT_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def round_scope(name: str):
    """Named region for a prover round (visible in profiler traces)."""
    return torch.profiler.record_function(f"plonk/{name}")


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed block and write its Chrome trace into `logdir`
    (created if missing) as `<host>_<pid>.<ns>.pt.trace.json`, also when
    the block raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}_{os.getpid()}."
                    f"{time.time_ns()}.pt.trace.json"))


def device_events(trace_path: str) -> list:
    """(name, microseconds) of each device event (kernel, memcpy, memset)
    of a Chrome trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_KINDS]


class Timer:
    """Wall-clock timing of the enclosed block (synchronise inside it)."""

    def __init__(self):
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def block_until_ready(out):
    """Wait for the CUDA devices that hold a tensor of `out` (tensors,
    possibly nested in tuples, lists and dicts); returns `out`."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def timeit(fn, *args, reps: int = 3, warmup: int = 1):
    """Simple average over `reps` calls after `warmup` ones; waits for the
    output's devices before and after the timed calls. Returns
    (seconds_per_call, last_output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def throughput(items: int, seconds: float) -> float:
    return items / seconds if seconds > 0 else float("inf")


def metrics_line(metric: str, value: float, unit: str,
                 vs_baseline: float | None = None, **extras) -> str:
    rec = {"metric": metric, "value": value, "unit": unit}
    if vs_baseline is not None:
        rec["vs_baseline"] = vs_baseline
    rec.update(extras)
    return json.dumps(rec)
