"""Parity of the port's fixed-base commit path with the JAX package:
the window table of build_commit_table word for word, and K2's plain
version (plonk_tpu_torch.ops.commit.commit_many_plain, affine out) against
the Pallas commit kernel run in interpret mode on the three cases of
tests/test_pallas_msm.py. Points compare affine; exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import curve as JC
from plonk_tpu.ops import pallas_msm as JPM
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import SCALED_CURVE, SCALED_FQ
from plonk_tpu_torch.ops import commit as CM
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops import fixed_base as FB
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.utils.convert import table_from_numpy

Fq, Jq = MontField(SCALED_FQ), JMontField(SCALED_FQ)
BITS = SCALED_CURVE.r.bit_length()


def _port_points(jpts) -> C.G1:
    return C.G1(torch.as_tensor(np.asarray(jpts.x).astype(np.int64)),
                torch.as_tensor(np.asarray(jpts.y).astype(np.int64)),
                torch.as_tensor(np.array(jpts.inf)))


def _random_points(rng, n):
    g = JC.g1_generator(SCALED_CURVE, Jq)
    ks = rng.integers(1, SCALED_CURVE.r, size=n, dtype=np.uint32)
    return JC.g1_mul(Jq, g, jnp.asarray(ks), nbits=BITS)


def _infinity_points():
    g = JC.g1_generator(SCALED_CURVE, Jq)
    ks = np.array([5, 0, 9, 0, 1, 2, 3, 4], dtype=np.uint32)
    return JC.g1_mul(Jq, g, jnp.asarray(ks), nbits=4)


def _assert_affine_equal(got: C.G1, want) -> None:
    np.testing.assert_array_equal(got.inf.numpy(), np.asarray(want.inf))
    fin = ~got.inf.numpy()
    for a, b in ((got.x, want.x), (got.y, want.y)):
        np.testing.assert_array_equal(a.numpy()[fin],
                                      np.asarray(b).astype(np.int64)[fin])


def test_build_commit_table_matches_jax():
    jpts = _random_points(np.random.default_rng(23), 40)
    want = JPM.build_commit_table(Jq, jpts, BITS, window_bits=4)
    got = CM.build_commit_table(Fq, _port_points(jpts), BITS, window_bits=4)
    assert got.x.shape == (8, 16, 40) and got.window_bits == 4
    for a, b in ((got.x, want.x), (got.y, want.y), (got.inf, want.inf)):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(a.numpy().dtype))


# the three cases of tests/test_pallas_msm.py: (points, scalars, tile)
def _case(name):
    if name == "n40_tile16":
        rng = np.random.default_rng(23)
        jpts = _random_points(rng, 40)
        sc = rng.integers(0, SCALED_CURVE.r, size=(3, 40), dtype=np.uint32)
        sc[0, 0] = 0
        sc[1, :] = 0                     # all-zero commitment -> infinity
        return jpts, sc, 16
    if name == "infinity_bases":
        rng = np.random.default_rng(29)
        sc = rng.integers(0, SCALED_CURVE.r, size=(2, 8), dtype=np.uint32)
        return _infinity_points(), sc, 8
    rng = np.random.default_rng(31)
    jpts = _random_points(rng, 300)
    sc = rng.integers(0, SCALED_CURVE.r, size=(2, 300), dtype=np.uint32)
    return jpts, sc, 256


@pytest.mark.parametrize("case", ["n40_tile16", "infinity_bases",
                                  "n300_tile256"])
def test_commit_plain_matches_pallas_interpret(case):
    jpts, sc, tile = _case(case)
    jtbl = JPM.build_commit_table(Jq, jpts, BITS, window_bits=4)
    want = JPM.msm_fixed_base_many_pallas(Jq, jtbl, jnp.asarray(sc),
                                          tile=tile, interpret=True)
    tbl = table_from_numpy(np.asarray(jtbl.x), np.asarray(jtbl.y),
                           np.asarray(jtbl.inf), jtbl.window_bits, "cpu")
    scalars = torch.as_tensor(sc.astype(np.int64))
    got = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    _assert_affine_equal(got, want)
    # the wrapper on CPU tensors, the gather and select selections, and the
    # port's own table all give the same points
    _assert_affine_equal(CM.msm_fixed_base_many_kernel(Fq, tbl, scalars),
                         want)
    own = CM.build_commit_table(Fq, _port_points(jpts), BITS)
    for mode in ("gather", "select"):
        _assert_affine_equal(FB.msm_fixed_base_many(Fq, own, scalars, mode),
                             want)
    if case == "n40_tile16":
        assert bool(got.inf[1])


# csrc/commit.cu cannot run here; these hold its packed table and its mixed
# addition against the port's table and complete addition.

def _port_table(n: int, seed: int):
    """A window table over n points with infinity bases among them."""
    jpts = _infinity_points() if n == 8 else _random_points(
        np.random.default_rng(seed), n)
    return CM.build_commit_table(Fq, _port_points(jpts), BITS)


@pytest.mark.parametrize("n", [8, 40])
def test_packed_commit_table_round_trip(n):
    """K2's packed words hold x | y << 32 of each entry, an infinity entry
    (row d = 0, the padded window, an infinity base) the x that no
    coordinate below p takes; unpacking gives the table back."""
    tbl = _port_table(n, 5)
    assert tbl.packed is None            # attached on a CUDA device only
    packed = CM.pack_commit_table(tbl)
    assert packed.shape == tbl.x.shape and packed.dtype == torch.int64
    assert Fq.p < CM.INFINITY_X
    fin = ~tbl.inf
    np.testing.assert_array_equal((packed & 0xFFFFFFFF)[fin], tbl.x[fin])
    np.testing.assert_array_equal((packed >> 32)[fin], tbl.y[fin])
    assert bool(((packed & 0xFFFFFFFF)[tbl.inf] == CM.INFINITY_X).all())
    assert bool(tbl.inf[:, 0].all()) and bool(tbl.inf[-1].all())
    base_inf = tbl.inf[:, 1:].reshape(-1, n).all(dim=0)   # infinity bases
    assert bool(base_inf.any()) == (n == 8)
    x = packed & 0xFFFFFFFF                     # unpacked: x = y = 0 at inf
    inf = x == CM.INFINITY_X
    for got, want in zip((torch.where(inf, 0, x),
                          torch.where(inf, 0, packed >> 32), inf), tbl[:3]):
        assert torch.equal(got, want)


def _madd_model(a: C.G1J, packed: torch.Tensor) -> C.G1J:
    """commit.cu jac_madd on packed entries, in PyTorch: madd-2007-bl (7
    products, 4 squares) with its complete cases; a sentinel entry leaves
    the accumulator as it is."""
    x2, y2 = packed & 0xFFFFFFFF, packed >> 32
    skip = x2 == CM.INFINITY_X
    mul, add, sub = Fq.mul, Fq.add, Fq.sub
    Z1Z1 = mul(a.Z, a.Z)
    U2 = mul(x2, Z1Z1)
    S2 = mul(y2, mul(a.Z, Z1Z1))
    H = sub(U2, a.X)
    r2 = sub(S2, a.Y)
    HH = mul(H, H)
    I = add(add(HH, HH), add(HH, HH))
    J = mul(H, I)
    r = add(r2, r2)
    V = mul(a.X, I)
    X3 = sub(sub(mul(r, r), J), add(V, V))
    YJ = mul(a.Y, J)
    Y3 = sub(mul(r, sub(V, X3)), add(YJ, YJ))
    ZH = add(a.Z, H)
    Z3 = sub(sub(mul(ZH, ZH), Z1Z1), HH)
    out = C.G1J(X3, Y3, Z3)
    one = Fq.ones(x2.shape, x2.device)
    dbl = C.jac_double(Fq, a)
    ident = C.G1J(one, one, torch.zeros_like(one))
    took = C.G1J(x2, y2, one)
    for cond, val in (((H == 0) & (r2 != 0), ident), ((H == 0) & (r2 == 0),
                                                     dbl),
                      (a.Z == 0, took), (skip, a)):
        out = C.G1J(*(torch.where(cond, v, o) for v, o in zip(val, out)))
    return out


def test_mixed_addition_model_matches_complete_addition():
    """K2's mixed addition equals the complete Jacobian addition, affine,
    on general operands and on the identity accumulator, equal points
    (doubling), inverse points and infinity (sentinel) entries, with
    accumulators of random Z."""
    rng = np.random.default_rng(7)
    g = C.g1_generator(SCALED_CURVE, Fq, "cpu")
    ks = rng.integers(1, SCALED_CURVE.r, size=(2, 60))
    pa = C.g1_mul(Fq, g, torch.as_tensor(ks[0]), nbits=BITS)
    pb = C.g1_mul(Fq, g, torch.as_tensor(ks[1]), nbits=BITS)
    pb = C.G1(torch.where(torch.arange(60) < 10, pa.x, pb.x),   # doubling
              torch.where(torch.arange(60) < 10, pa.y,
                          torch.where(torch.arange(60) < 20,     # inverse
                                      Fq.sub(torch.zeros_like(pa.y), pa.y),
                                      pb.y)),
              pb.inf.clone())
    pb.x[10:20] = pa.x[10:20]
    pb.inf[20:30] = True                                        # sentinel
    z = torch.as_tensor(Fq.encode_host(rng.integers(1, Fq.p, size=60)))
    z[30:40] = 0                                                # identity
    zz = Fq.mul(z, z)
    a = C.G1J(Fq.mul(pa.x, zz), Fq.mul(pa.y, Fq.mul(zz, z)), z)
    a = C.G1J(torch.where(z == 0, Fq.ones((60,), "cpu"), a.X),
              torch.where(z == 0, Fq.ones((60,), "cpu"), a.Y), a.Z)
    packed = CM.pack_commit_table(FB.FixedBaseTable(pb.x, pb.y, pb.inf, 4))
    got = C.jac_to_affine(Fq, _madd_model(a, packed))
    want = C.jac_to_affine(Fq, C.jac_add(Fq, a, C.jac_from_affine(Fq, pb)))
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert bool(got.inf[10:20].all())                 # P + (-P)
    assert bool(got.inf[30:40].logical_not().all())   # identity takes it
