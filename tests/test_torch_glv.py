"""The port's GLV decomposition and MSM (plonk_tpu_torch.ops.glv) against
the JAX package's (plonk_tpu.ops.glv), on the CPU.

- the constants (beta, lam, the lattice basis, the rounding constants)
  and the host decomposition equal JAX's;
- the device decomposition equals JAX's glv_decompose word for word
  (magnitudes and signs, tolerance zero) and the host oracle, on 0, 1,
  r - 1, lam, lam + 1, r - lam and seeded scalars, among them scalars with
  negative k1 and with negative k2;
- glv_split_points equals JAX's;
- big_msm_glv(_many) on the inputs of tests/test_torch_big_pippenger.py
  equals JAX's in affine form (values recorded in tests/golden/
  msm_jax.json, as JAX's GLV MSM compiles for minutes on XLA:CPU; `-k
  recompute` under PLONK_TPU_HEAVY_TESTS recomputes them), the
  python-int oracle and the port's plain Pippenger.
"""
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from plonk_tpu.ops import bigcurve as JBC
from plonk_tpu.ops import glv as JG
from plonk_tpu_torch.ops import bigcurve as BC
from plonk_tpu_torch.ops import glv as G
from plonk_tpu_torch.ops.bigfield import _from_words
from test_torch_big_pippenger import (LENGTHS, Fq, R, golden_entry, heavy,
                                      host_msm, jax_affine, jax_points,
                                      load_golden, msm_inputs, port_affine,
                                      port_points, scalar_words)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py


def _scalars() -> list:
    _, lam, _ = G.glv_constants()
    rng = np.random.default_rng(7)
    return [0, 1, R - 1, lam, lam + 1, R - lam] + [
        int.from_bytes(rng.bytes(32), "little") % R for _ in range(58)]


def test_constants_match_jax():
    assert G.glv_constants() == JG.glv_constants()
    assert G._decomp_consts() == JG._decomp_consts()
    assert (G._S_BITS, G._KL) == (JG._S_BITS, JG._KL)
    beta, lam, ((a1, b1), (a2, b2)) = G.glv_constants()
    assert pow(beta, 3, BC.BN254_FQ.p) == 1 != beta
    assert pow(lam, 3, R) == 1 != lam
    assert (a1 + b1 * lam) % R == 0 == (a2 + b2 * lam) % R


def test_host_decomposition_matches_jax():
    _, lam, _ = G.glv_constants()
    for k in _scalars():
        k1, k2 = G.glv_decompose_host(k)
        assert (k1, k2) == JG.glv_decompose_host(k)
        assert (k1 + k2 * lam - k) % R == 0
        assert abs(k1) < 1 << 131 and abs(k2) < 1 << 131


def test_device_decomposition_matches_jax_word_for_word():
    ks = _scalars()
    sw = np.array([[(k >> (16 * i)) & 0xFFFF for i in range(16)]
                   for k in ks])
    got = G.glv_decompose(torch.as_tensor(sw))
    want = JG.glv_decompose(jnp.asarray(sw, jnp.uint32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k1, k1_neg, k2, k2_neg = got
    assert k1.shape == (len(ks), 9) and k1_neg.dtype == torch.bool
    signs = set()
    for i, k in enumerate(ks):
        h1, h2 = G.glv_decompose_host(k)
        assert _from_words(k1[i]) == abs(h1) and bool(k1_neg[i]) == (h1 < 0)
        assert _from_words(k2[i]) == abs(h2) and bool(k2_neg[i]) == (h2 < 0)
        signs.add((h1 < 0, h2 < 0))
    assert {(True, False), (False, True)} <= signs
    assert (G.glv_decompose_host(0) == (0, 0)
            and not bool(k1_neg[0]) and not bool(k2_neg[0]))


def test_split_points_matches_jax():
    pts, _ = msm_inputs(13)
    rng = np.random.default_rng(3)
    n1, n2 = rng.integers(0, 2, size=(2, 13)).astype(bool)
    got = G.glv_split_points(Fq, port_points(pts), torch.as_tensor(n1),
                             torch.as_tensor(n2))
    Fj = JBC.BigMontField(JBC.BN254_FQ)
    want = JG.glv_split_points(Fj, jax_points(pts), jnp.asarray(n1),
                               jnp.asarray(n2))
    assert got.X.shape == (26, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module", params=LENGTHS)
def case(request):
    L = request.param
    pts, scalars = msm_inputs(L)
    P = port_points(pts)
    sw = torch.as_tensor(scalar_words(scalars))
    with torch.inference_mode():
        many = port_affine(Fq, G.big_msm_glv_many(Fq, P, sw))
        one = port_affine(Fq, BC.BigG1J(
            *(c[None] for c in G.big_msm_glv(Fq, P, sw[1]))))
    return L, pts, scalars, many, one


def test_glv_many_matches_oracle(case):
    L, pts, scalars, many, _ = case
    assert many == host_msm(pts, scalars)
    assert many[3] == [0, 0, True]


def test_glv_many_matches_recorded_jax(case, golden):
    L, _, _, many, _ = case
    assert many == golden[f"glv_many_L{L}"]


def test_glv_single_matches_recorded_jax(case, golden):
    L, _, _, many, one = case
    assert one == golden[f"glv_L{L}"] == [many[1]]


def test_glv_equals_plain_pippenger(case, golden):
    """The two routes give one group element, as JAX's test_glv asserts."""
    L, _, _, many, _ = case
    assert many == golden[f"pippenger_many_L{L}"]


@heavy
@pytest.mark.parametrize("L", LENGTHS)
def test_recompute_jax_glv(L):
    import jax
    Fj = JBC.BigMontField(JBC.BN254_FQ, rolled=True)
    pts, scalars = msm_inputs(L)
    P = jax_points(pts)
    sw = jnp.asarray(scalar_words(scalars).astype(np.uint32))
    many = jax_affine(Fj, jax.jit(lambda p, s: JG.big_msm_glv_many(
        Fj, p, s))(P, sw))
    one = jax_affine(Fj, jax.tree_util.tree_map(
        lambda a: a[None], jax.jit(lambda p, s: JG.big_msm_glv(
            Fj, p, s))(P, sw[1])))
    print(json.dumps({f"glv_many_L{L}": golden_entry(many),
                      f"glv_L{L}": golden_entry(one)}))
    assert many == host_msm(pts, scalars)
    golden = load_golden()
    assert many == golden[f"glv_many_L{L}"]
    assert one == golden[f"glv_L{L}"]
