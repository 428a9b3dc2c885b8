"""Parity of plonk_tpu_torch.ops.field.MontField with the JAX MontField:
every op gives the same words (tolerance 0: field words are unique)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import BABYBEAR, SCALED_FQ, SCALED_FR
from plonk_tpu_torch.ops.field import MontField

FIELDS = [SCALED_FR, SCALED_FQ, BABYBEAR]


def _inputs(p: int, seed: int, n: int = 61) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2, p - 2, p - 1], dtype=np.int64)
    return np.concatenate([edge, rng.integers(0, p, size=n)])


def _pair(params, seed):
    a = _inputs(params.p, seed)
    b = np.roll(_inputs(params.p, seed + 1), 3)
    return a, b


def _j(x: np.ndarray):
    return jnp.asarray(x.astype(np.uint32))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(x.astype(np.int64))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("params", FIELDS, ids=lambda f: f.name)
def test_field_constants_and_encoding(params):
    F, J = MontField(params), JMontField(params)
    assert (F.n_prime, F.r_mod_p, F.r2_mod_p) == (J.n_prime, J.r_mod_p,
                                                   J.r2_mod_p)
    a, _ = _pair(params, 1)
    _eq(F.encode(_t(a)), J.encode(_j(a)))
    _eq(F.decode(_t(a)), J.decode(_j(a)))
    _eq(F.decode(F.encode(_t(a))), a)
    ints = np.array([-5, -1, 0, 1, params.p - 1, params.p, 3 * params.p + 7])
    np.testing.assert_array_equal(F.encode_host(ints),
                                  J.encode_host(ints).astype(np.int64))
    _eq(F.array(ints, "cpu"), J.array(ints))
    for v in (0, 1, 2, -1, params.p + 5):
        assert F.const(v) == int(J.const(v))
    _eq(F.ones((3,), "cpu"), J.ones((3,)))


@pytest.mark.parametrize("params", FIELDS, ids=lambda f: f.name)
def test_field_arithmetic_matches_jax(params):
    F, J = MontField(params), JMontField(params)
    a, b = _pair(params, 7)
    ta, tb, ja, jb = _t(a), _t(b), _j(a), _j(b)
    _eq(F.add(ta, tb), J.add(ja, jb))
    _eq(F.sub(ta, tb), J.sub(ja, jb))
    _eq(F.neg(ta), J.neg(ja))
    _eq(F.mul(ta, tb), J.mul(ja, jb))
    _eq(F.square(ta), J.square(ja))
    _eq(F.div(ta, tb), J.div(ja, jb))
    for e in (0, 1, 5, 1000003):
        _eq(F.pow_static(ta, e), J.pow_static(ja, e))
    # a Python-int operand broadcasts like a JAX scalar constant
    _eq(F.mul(ta, F.const(3)), J.mul(ja, J.const(3)))


@pytest.mark.parametrize("params", FIELDS, ids=lambda f: f.name)
def test_field_inverse_and_zero(params):
    F, J = MontField(params), JMontField(params)
    a, _ = _pair(params, 11)
    inv = F.inv(_t(a))
    _eq(inv, J.inv(_j(a)))
    assert int(inv[0]) == 0                      # inv(0) = 0
    nz = a != 0
    _eq(F.mul(_t(a), inv)[nz], np.full(nz.sum(), F.r_mod_p))
    _eq(F.div(_t(a), torch.zeros(len(a), dtype=torch.int64)),
        np.zeros(len(a)))                        # div by 0 = 0
    _eq(F.pow_static(torch.zeros(2, dtype=torch.int64), 0),
        np.full(2, F.r_mod_p))                   # 0^0 = 1
