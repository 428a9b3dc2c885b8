"""The port's profiling helpers (plonk_tpu_torch.utils.profiling) against
the JAX package's plonk_tpu.utils.profiling: metrics_line gives JAX's
string, throughput JAX's value (0 s included); timeit returns the last
output; trace_to writes a Chrome trace whose events hold a round_scope
region's name, which device_events reads without error, also when the
traced block raises."""
import glob
import json
import math
import os

import pytest
import torch

from plonk_tpu.utils import profiling as JP
from plonk_tpu_torch.utils import profiling as P


@pytest.mark.parametrize("args,kwargs", [
    (("proofs_per_s", 2.5, "proofs/s"), {}),
    (("g1_msm_points_per_s", 123456.789, "points/s"),
     dict(vs_baseline=1.25)),
    (("ntt_elems_per_s", 0, "elems/s"),
     dict(vs_baseline=None, n=65536, device="H100", shards=[1, 8])),
    (("verify_s", float("inf"), "s"), dict(vs_baseline=0.5, ok=True)),
])
def test_metrics_line_matches_jax(args, kwargs):
    got = P.metrics_line(*args, **kwargs)
    assert got == JP.metrics_line(*args, **kwargs)
    assert list(json.loads(got))[:3] == ["metric", "value", "unit"]


@pytest.mark.parametrize("items,seconds", [(65536, 0.25), (7, 3.0), (5, 0.0),
                                           (0, 0.0), (3, -1.0)])
def test_throughput_matches_jax(items, seconds):
    got, want = P.throughput(items, seconds), JP.throughput(items, seconds)
    assert got == want or (math.isinf(got) and math.isinf(want))


def test_timeit_returns_last_output():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.full((3,), len(calls)), {"n": [torch.tensor(len(calls))]}

    sec, out = P.timeit(fn, 7, reps=3, warmup=2)
    assert calls == [7] * 5 and sec >= 0
    assert out[0].tolist() == [5, 5, 5] and int(out[1]["n"][0]) == 5
    with P.Timer() as t:
        P.block_until_ready(out)
    assert t.elapsed >= 0


def test_trace_to_writes_round_scope(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace_to(logdir):
        with P.round_scope("round1"):
            torch.ones(64).cumsum(0)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "plonk/round1" in names
    assert P.device_events(files[0]) == []      # no device on the CPU


def test_trace_to_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with P.trace_to(str(tmp_path)):
            with P.round_scope("failing"):
                1 / 0
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
