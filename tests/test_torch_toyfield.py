"""Parity of the port's direct-reduction Field (F17, F101), its pow with
tensor exponents, MontField.pow, make_field and the toy presets with the
JAX package: every op gives the same words (tolerance 0: field words are
unique), over every pair of elements of both toy fields."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import field as JFM
from plonk_tpu.utils import params as JPR
from plonk_tpu_torch.ops import field as FM
from plonk_tpu_torch.utils import params as PR

TOY = ["HF17", "GF101"]


def _grid(p: int):
    """Every pair (a, b) of F_p, flattened."""
    a, b = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    return a.ravel(), b.ravel()


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def _fields(name: str):
    """The port's and JAX's Field of one preset, and the preset."""
    return (FM.Field(getattr(PR, name)), JFM.Field(getattr(JPR, name)),
            getattr(PR, name))


def test_presets_match_jax():
    for name in ("HF17", "GF101", "TOY_CURVE", "TOY_PLONK", "BABYBEAR",
                 "BLS12_381_FR", "SCALED_FR", "SCALED_FQ", "SCALED_CURVE",
                 "BN254_FR"):
        assert dataclasses.asdict(getattr(PR, name)) == \
            dataclasses.asdict(getattr(JPR, name)), name
    assert PR.PRESET_FIELDS.keys() == JPR.PRESET_FIELDS.keys()
    for k, v in PR.PRESET_FIELDS.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(
            JPR.PRESET_FIELDS[k]), k
    assert PR.TOY_CURVE.final_exp == 600
    assert PR.TOY_PLONK.field == PR.HF17


@pytest.mark.parametrize("name", TOY)
def test_every_pair_matches_jax(name):
    """add, sub, mul, div over all p^2 pairs; neg, inv, square over all p."""
    F, J, params = _fields(name)
    a, b = _grid(params.p)
    for op in ("add", "sub", "mul", "div"):
        _eq(getattr(F, op)(_t(a), _t(b)), getattr(J, op)(_j(a), _j(b)))
    x = np.arange(params.p)
    for op in ("neg", "inv", "square"):
        _eq(getattr(F, op)(_t(x)), getattr(J, op)(_j(x)))
    # reference behaviours: inv(0) = 0, a / 0 = 0
    assert int(F.inv(_t(0))) == 0
    _eq(F.div(_t(x), _t(np.zeros_like(x))), np.zeros_like(x))


@pytest.mark.parametrize("name", TOY)
def test_pow_static_every_pair_matches_jax(name):
    """a^e for every a and every static exponent e in [0, p], 0^0 = 1."""
    F, J, params = _fields(name)
    x = np.arange(params.p)
    for e in range(params.p + 1):
        _eq(F.pow_static(_t(x), e), J.pow_static(_j(x), e))
    assert int(F.pow_static(_t(0), 0)) == 1
    with pytest.raises(ValueError):
        F.pow_static(_t(x), -1)


@pytest.mark.parametrize("name", TOY)
def test_pow_tensor_exponents_match_jax(name):
    """pow with per-element exponents over the p x (p + 1) grid, with
    nbits bounding the ladder as JAX's does."""
    F, J, params = _fields(name)
    a, e = np.meshgrid(np.arange(params.p), np.arange(params.p + 1),
                       indexing="ij")
    a, e = a.ravel(), e.ravel()
    _eq(F.pow(_t(a), _t(e)), J.pow(_j(a), _j(e)))
    _eq(F.pow(_t(a), _t(e), nbits=3), J.pow(_j(a), _j(e), nbits=3))
    _eq(F.pow(_t(a), _t(e)), [pow(int(u), int(v), params.p)
                              for u, v in zip(a, e)])
    assert int(F.pow(_t(0), _t(0))) == 1


@pytest.mark.parametrize("name", TOY)
def test_constructors_and_signed_reduction(name):
    F, J, params = _fields(name)
    p = params.p
    for v in (-3 * p - 1, -p, -1, 0, 1, p - 1, p, 5 * p + 3):
        assert F.const(v) == int(J.const(v)) == v % p
        assert F.hconst(v) == J.hconst(v)
    ints = np.array([-2 * p - 5, -1, 0, 7, p, 3 * p + 1])
    _eq(F.array(ints, "cpu"), J.array(ints))
    signed = np.array([17, -1, 34, 51, 18, -17, -18, -35, 0, 16, 101, 102,
                       -101, 1015, -1015, 2 ** 31 - 1, -2 ** 31],
                      dtype=np.int32)
    _eq(F.from_signed(torch.as_tensor(signed)),
        J.from_signed(jnp.asarray(signed)))
    _eq(F.zeros((2, 3), "cpu"), J.zeros((2, 3)))
    _eq(F.ones((2, 3), "cpu"), J.ones((2, 3)))
    assert F.hpow(3, 5) == J.hpow(3, 5) and F.hinv(5) == J.hinv(5)


def test_from_signed_c_semantics():
    """src/hf.h:25-34: C's remainder, then + p when negative."""
    F17, F101 = FM.Field(PR.HF17), FM.Field(PR.GF101)
    vals = torch.tensor([17, -1, 34, 51, 18, -17, -18, -35, 0, 16],
                        dtype=torch.int32)
    _eq(F17.from_signed(vals), [0, 16, 0, 0, 1, 0, 16, 16, 0, 16])
    vals = torch.tensor([101, 102, -1, -101, 1015, -1015], dtype=torch.int32)
    _eq(F101.from_signed(vals), [0, 1, 100, 0, 5, 96])


@pytest.mark.parametrize("name", TOY)
def test_out_of_range_words_wrap_as_uint32(name):
    """JAX's uint32 sub and neg wrap at 2^32; the int64 words match."""
    F, J, params = _fields(name)
    p = params.p
    a = np.array([0, 1, p - 1, 0, 5, 2 ** 32 - 1])
    b = np.array([p + 5, 2 * p, 3 * p, 2 ** 32 - 1, 2 ** 31, 7])
    _eq(F.sub(_t(a), _t(b)), J.sub(_j(a), _j(b)))
    _eq(F.add(_t(a), _t(b)), J.add(_j(a), _j(b)))
    _eq(F.neg(_t(b)), J.neg(_j(b)))
    _eq(F.mul(_t(b), _t(b)), J.mul(_j(b), _j(b)))


def test_direct_field_refuses_large_p():
    with pytest.raises(ValueError):
        FM.Field(PR.BABYBEAR)


def test_make_field_dispatch():
    assert isinstance(FM.make_field(PR.HF17), FM.Field)
    assert isinstance(FM.make_field(PR.GF101), FM.Field)
    assert isinstance(FM.make_field(PR.BABYBEAR), FM.MontField)
    assert isinstance(FM.make_field(PR.SCALED_FQ), FM.MontField)
    for name in ("HF17", "GF101", "BABYBEAR", "SCALED_FR"):
        assert type(FM.make_field(getattr(PR, name))).__name__ == type(
            JFM.make_field(getattr(JPR, name))).__name__


def test_montfield_pow_matches_jax():
    """MontField.pow on BabyBear with tensor exponents, against JAX's and
    against Python's pow."""
    F, J = FM.MontField(PR.BABYBEAR), JFM.MontField(JPR.BABYBEAR)
    p = PR.BABYBEAR.p
    rng = np.random.default_rng(17)
    a = np.concatenate([[0, 0, 1, p - 1, 2], rng.integers(0, p, 59)])
    e = np.concatenate([[0, 5, 0, 2 ** 32 - 1, p - 2],
                        rng.integers(0, 2 ** 32, 59)])
    ta = F.encode(_t(a))
    got = F.pow(ta, _t(e))
    _eq(got, J.pow(J.encode(_j(a)), _j(e)))
    _eq(F.decode(got), [pow(int(u), int(v), p) for u, v in zip(a, e)])
    _eq(F.pow(ta, _t(e), nbits=7), J.pow(J.encode(_j(a)), _j(e), nbits=7))
    # scalar exponent broadcast against a vector
    _eq(F.pow(ta, 3), J.pow(J.encode(_j(a)), 3))
