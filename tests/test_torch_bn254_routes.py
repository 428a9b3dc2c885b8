"""The port's two BN254 commit routes and its three switches, on the CPU
at n = 8: the proof of tests/test_torch_bn254.py and the verifying key
under PLONK_TPU_BN254_FB = 1 (the window table) and 0 (no table), each
with PLONK_TPU_BN254_GLV = 1 (GLV) and 0 (plain Pippenger), equal word for
word to the JAX package's (tolerance zero): the proof to the values
recorded in tests/test_torch_bn254.py, the verifying key to JAX's
make_vk_bn254 (which commits by GLV), recorded once in
tests/golden/bn254_vk_jax.json because it compiles for minutes on
XLA:CPU; under PLONK_TPU_HEAVY_TESTS `-k recompute` recomputes it. Each
route is seen to run (the MSM it calls is counted), and the switches'
defaults are JAX's: the table on a CUDA device, not on the CPU.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models.synthetic import (bn254_mul_circuit, from_words,
                                              words_vec)
from test_torch_bn254 import CH, JAX_POINTS, JAX_SCALARS, N, RND, SECRET
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

VK_PATH = os.path.join(os.path.dirname(__file__), "golden",
                       "bn254_vk_jax.json")
# (PLONK_TPU_BN254_FB, PLONK_TPU_BN254_GLV) -> the MSM the route runs
ROUTES = {("1", "1"): "big_commit_many", ("1", "0"): "big_commit_many",
          ("0", "1"): "big_msm_glv_many", ("0", "0"): "big_msm_pippenger_many"}


def _vk_fields(vk) -> dict:
    return {k: [hex(from_words(p.x)), hex(from_words(p.y)), bool(p.inf)]
            for k, p in zip(PB.BN254VK._fields, vk)}


@pytest.fixture(scope="module")
def ctx():
    return PB.bn254_setup(N, secret=SECRET, device="cpu")


@pytest.fixture(scope="module", params=list(ROUTES),
                ids=lambda r: f"FB{r[0]}-GLV{r[1]}")
def routed(request, ctx):
    """make_prover_bn254's proof and make_vk_bn254's key under the
    route's switches, and the calls of each MSM they made."""
    fb, glv = request.param
    calls = collections.Counter()
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setenv("PLONK_TPU_BN254_FB", fb)
        mp.setenv("PLONK_TPU_BN254_GLV", glv)
        for name in set(ROUTES.values()):
            def counted(*a, _f=getattr(PB, name), _n=name, **k):
                calls[_n] += 1
                return _f(*a, **k)
            mp.setattr(PB, name, counted)
        sel, cp, a, b, c = bn254_mul_circuit(N)
        proof, diags = PB.make_prover_bn254(ctx, sel, cp)(a, b, c, CH, RND)
        vk = PB.make_vk_bn254(ctx, sel, cp)
    return request.param, proof, diags, vk, calls


def test_the_route_runs(routed):
    route, _, _, _, calls = routed
    assert calls == {ROUTES[route]: 2}       # the proof's and the key's


def test_proof_matches_recorded_jax(routed):
    _, proof, diags, _, _ = routed
    assert bool(diags.all_ok())
    for name, (x, y) in JAX_POINTS.items():
        p = getattr(proof, name)
        assert (from_words(p.x), from_words(p.y), bool(p.inf)) == \
            (x, y, False), name
    for name, v in JAX_SCALARS.items():
        assert from_words(getattr(proof, name)) == v, name


def test_vk_matches_recorded_jax(routed):
    with open(VK_PATH) as f:
        assert _vk_fields(routed[3]) == json.load(f)


def test_switch_defaults(monkeypatch):
    """Unset, the table route is on for a CUDA device and off on the CPU;
    PLONK_TPU_BN254_FB=1/0 decides for both."""
    monkeypatch.delenv("PLONK_TPU_BN254_FB", raising=False)
    assert PB.use_bn254_fixed_base("cuda")
    assert not PB.use_bn254_fixed_base("cpu")
    for flag, want in (("1", True), ("0", False)):
        monkeypatch.setenv("PLONK_TPU_BN254_FB", flag)
        assert [PB.use_bn254_fixed_base(d) for d in ("cpu", "cuda")] == \
            [want, want]


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="compiles the JAX package's BN254 setup and GLV "
                           "commitments (minutes of XLA:CPU); set "
                           "PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_vk():
    from plonk_tpu.models import plonk_bn254 as JPB
    sel, cp = bn254_mul_circuit(N)[:2]
    jctx = JPB.bn254_setup(N, secret=SECRET, rolled=True)
    vk = JPB.make_vk_bn254(jctx, sel, cp)
    got = {k: [hex(from_words(np.asarray(p.x))),
               hex(from_words(np.asarray(p.y))), bool(p.inf)]
           for k, p in zip(JPB.BN254VK._fields, vk)}
    print(json.dumps(got, indent=1))
    with open(VK_PATH) as f:
        assert got == json.load(f)
