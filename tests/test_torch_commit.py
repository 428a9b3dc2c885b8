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
