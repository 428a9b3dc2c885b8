"""The port's BN254 Pippenger MSM over arbitrary points
(plonk_tpu_torch.ops.bigcurve: big_digits, big_msm_pippenger,
big_msm_pippenger_many) against the JAX package's, on the CPU.

- window digits equal JAX's `_big_digits` and `_big_digits_batch` word for
  word (tolerance zero), at widths that divide 16 and that straddle words;
- the MSMs, at L = 16 and at L = 13, on 4 lanes of numpy-seeded scalars
  (random; random with zeros; every scalar 0x2A..2A, so every window
  digit of every point is 0x2A; all zero) over seeded multiples of G with
  an infinite point, a repeated point and a point and its negative,
  equal JAX's in affine form (Jacobian coordinates depend on the order of
  addition) and the python-int oracle of tests/bn254_oracle.py.

JAX's Pippenger compiles for minutes on XLA:CPU, so its points were
recorded once (tests/golden/msm_jax.json, shared with
tests/test_torch_glv.py): they are what

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_big_pippenger.py -k recompute

prints; that test, skipped without the heavy-test flag, recomputes them
and compares.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import bn254_oracle as O
from plonk_tpu.ops import bigcurve as JBC
from plonk_tpu_torch.ops import bigcurve as BC
from plonk_tpu_torch.ops.bigfield import BigMontField

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

R = O.R
Fq = BigMontField(BC.BN254_FQ)
LENGTHS = (13, 16)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "msm_jax.json")
heavy = pytest.mark.skipif(
    not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
    reason="compiles the JAX package's MSMs (minutes of XLA:CPU); set "
           "PLONK_TPU_HEAVY_TESTS=1")


def _words(k: int) -> list:
    return [(k >> (16 * i)) & 0xFFFF for i in range(16)]


def msm_inputs(L: int):
    """(host points, (4, L) python-int scalars) for the MSM tests: seeded
    multiples m_i G with m_3 = 0 (infinity), P_5 = P_4 and P_7 = -P_6;
    lanes as the module docstring lists them."""
    rng = np.random.default_rng(L)
    mults = [int(m) for m in rng.integers(1, 1 << 20, size=L)]
    mults[3] = 0
    mults[5] = mults[4]
    mults[7] = R - mults[6]
    pts = [O.g1_mul(O.G1_GEN, m) if m else None for m in mults]
    rand = lambda: int.from_bytes(rng.bytes(32), "little") % R
    zeros = [0 if i % 3 == 0 else rand() for i in range(L)]
    equal = int.from_bytes(bytes([0x2A] * 32), "little")
    scalars = [[rand() for _ in range(L)], zeros, [equal] * L, [0] * L]
    return pts, scalars


def port_points(pts) -> BC.BigG1J:
    """Host affine points (None at infinity) -> the port's Jacobian
    batch (L, 16)."""
    x = Fq.array([p[0] if p else 0 for p in pts], "cpu")
    y = Fq.array([p[1] if p else 0 for p in pts], "cpu")
    return BC.affine_to_jac(Fq, x, y, torch.tensor([p is None for p in pts]))


def jax_points(pts):
    """The same points as the JAX package's BigG1J (uint32 words)."""
    P = port_points(pts)
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    return JBC.BigG1J(u32(P.X), u32(P.Y), u32(P.Z))


def scalar_words(scalars) -> np.ndarray:
    return np.array([[_words(k) for k in row] for row in scalars],
                    dtype=np.int64)


def host_msm(pts, scalars) -> list:
    """sum_i k_i P_i of each lane on the python-int oracle, as
    [x, y, infinity] with zeros at infinity."""
    out = []
    for row in scalars:
        acc = None
        for p, k in zip(pts, row):
            if p is not None and k:
                acc = O.g1_add(acc, O.g1_mul(p, k))
        out.append([0, 0, True] if acc is None else [acc[0], acc[1], False])
    return out


def port_affine(F, out) -> list:
    """A port Jacobian batch (B,) -> [[x, y, infinity], ...] standard."""
    x, y, inf = BC.big_to_affine(F, out)
    xs, ys = F.decode_host(x), F.decode_host(y)
    return [[int(a), int(b), bool(c)] for a, b, c in
            zip(xs.reshape(-1), ys.reshape(-1), inf.reshape(-1).tolist())]


def jax_affine(F, out) -> list:
    """A JAX Jacobian batch -> [[x, y, infinity], ...] standard."""
    x, y, inf = JBC.big_to_affine(F, out)
    x, y = np.asarray(F.decode(x)), np.asarray(F.decode(y))
    from_w = lambda w: sum(int(v) << (16 * k) for k, v in enumerate(w))
    return [[from_w(a), from_w(b), bool(c)] for a, b, c in
            zip(x.reshape(-1, 16), y.reshape(-1, 16),
                np.asarray(inf).reshape(-1))]


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        raw = json.load(f)
    return {name: [[int(x, 16), int(y, 16), inf] for x, y, inf in pts]
            for name, pts in raw.items()}


def golden_entry(pts: list) -> list:
    return [[hex(x), hex(y), inf] for x, y, inf in pts]


# ---- digits ----

@pytest.mark.parametrize("wb", [4, 5, 8, 13])
def test_digits_match_jax(wb):
    rng = np.random.default_rng(wb)
    sw = rng.integers(0, 1 << 16, size=(3, 11, 16))
    W = -(-254 // wb)
    got = BC.big_digits(torch.as_tensor(sw), wb, W)
    want = JBC._big_digits_batch(jnp.asarray(sw, jnp.uint32), wb, W, 16)
    assert got.shape == (3, W, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got1 = BC.big_digits(torch.as_tensor(sw[1]), wb, W)
    want1 = JBC._big_digits(jnp.asarray(sw[1], jnp.uint32), wb, W)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


# ---- MSMs ----

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
        many = port_affine(Fq, BC.big_msm_pippenger_many(Fq, P, sw))
        one = port_affine(Fq, BC.BigG1J(
            *(c[None] for c in BC.big_msm_pippenger(Fq, P, sw[1]))))
    return L, pts, scalars, many, one


def test_pippenger_many_matches_oracle(case):
    L, pts, scalars, many, _ = case
    assert many == host_msm(pts, scalars)
    assert many[3] == [0, 0, True]


def test_pippenger_many_matches_recorded_jax(case, golden):
    L, _, _, many, _ = case
    assert many == golden[f"pippenger_many_L{L}"]


def test_pippenger_single_matches_recorded_jax(case, golden):
    L, _, _, many, one = case
    assert one == golden[f"pippenger_L{L}"] == [many[1]]


def test_pippenger_lanes_with_their_own_points():
    """Points (B, L, 16), one set a lane (the GLV split's form): lane b
    equals the MSM of its own points."""
    pts, scalars = msm_inputs(13)
    P = port_points(pts)
    swap = BC.BigG1J(*(torch.stack([c, c.flip(0)]) for c in P))
    sw = torch.as_tensor(scalar_words(scalars[:2]))
    with torch.inference_mode():
        got = port_affine(Fq, BC.big_msm_pippenger_many(Fq, swap, sw))
    assert got == host_msm(pts, scalars[:1]) + host_msm(
        pts[::-1], scalars[1:2])


def test_pippenger_window_and_chunk():
    """5-bit windows (digits that straddle words) with additions run 64
    points at a time give the same points."""
    pts, scalars = msm_inputs(16)
    with torch.inference_mode():
        got = port_affine(Fq, BC.big_msm_pippenger_many(
            Fq, port_points(pts), torch.as_tensor(scalar_words(scalars[:2])),
            window_bits=5, chunk=64))
    assert got == host_msm(pts, scalars[:2])


@heavy
@pytest.mark.parametrize("L", LENGTHS)
def test_recompute_jax_pippenger(L):
    import jax
    Fj = JBC.BigMontField(JBC.BN254_FQ, rolled=True)
    pts, scalars = msm_inputs(L)
    P = jax_points(pts)
    sw = jnp.asarray(scalar_words(scalars).astype(np.uint32))
    many = jax_affine(Fj, jax.jit(lambda p, s: JBC.big_msm_pippenger_many(
        Fj, p, s))(P, sw))
    one = jax_affine(Fj, jax.tree_util.tree_map(
        lambda a: a[None], jax.jit(lambda p, s: JBC.big_msm_pippenger(
            Fj, p, s))(P, sw[1])))
    print(json.dumps({f"pippenger_many_L{L}": golden_entry(many),
                      f"pippenger_L{L}": golden_entry(one)}))
    assert many == host_msm(pts, scalars)
    golden = load_golden()
    assert many == golden[f"pippenger_many_L{L}"]
    assert one == golden[f"pippenger_L{L}"]
