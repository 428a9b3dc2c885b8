"""The port's 16-limb field (plonk_tpu_torch/ops/bigfield.py) against the
JAX package's BigMontField(rolled=True) on the same inputs, on the CPU.

Inputs are made with numpy from a seed and include 0, 1 and p - 1. Fully
reduced Montgomery words are unique, so the tolerance is zero: the words
are equal. The JAX side runs as one jitted function per field.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops.bigcurve import BN254_FQ as J_BN254_FQ
from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
from plonk_tpu.ops.bigfield import big_intt as j_big_intt
from plonk_tpu.ops.bigfield import big_ntt as j_big_ntt
from plonk_tpu.utils import params as JP
from plonk_tpu_torch.ops.bigcurve import BN254_FQ
from plonk_tpu_torch.ops.bigfield import BigMontField, big_intt, big_ntt
from plonk_tpu_torch.utils import params as P

# several test processes share the host: one thread each keeps the
# many small launches of the limb arithmetic from oversubscribing it
torch.set_num_threads(1)

FIELDS = {"BN254-Fr": (P.BN254_FR, JP.BN254_FR),
          "BN254-Fq": (BN254_FQ, J_BN254_FQ)}
OPS = ("add", "sub", "neg", "mont_mul", "square", "inv", "pow", "encode",
       "decode")


def _ints(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    xs[:4] = [0, 1, p - 1, p // 2]
    return xs


@pytest.fixture(scope="module", params=list(FIELDS))
def field_case(request):
    """(port field, inputs as port tensors, the JAX results by op)."""
    params, jparams = FIELDS[request.param]
    F, JF = BigMontField(params), JBigMontField(jparams, rolled=True)
    xs, ys = _ints(F.p, 24, 1), _ints(F.p, 24, 2)[::-1]
    a, b = F.array(xs, "cpu"), F.array(ys, "cpu")
    std = torch.as_tensor([[(v >> (16 * k)) & 0xFFFF for k in range(16)]
                           for v in xs])

    def jax_ops(a, b, s):
        return dict(add=JF.add(a, b), sub=JF.sub(a, b), neg=JF.neg(a),
                    mont_mul=JF.mont_mul(a, b), square=JF.square(a),
                    inv=JF.inv(a), pow=JF.pow_static(a, 5),
                    encode=JF.encode(s), decode=JF.decode(a))

    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    want = jax.jit(jax_ops)(u32(a), u32(b), u32(std))
    return F, a, b, std, xs, {k: np.asarray(v).astype(np.int64)
                              for k, v in want.items()}


@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(field_case, op):
    F, a, b, std, xs, want = field_case
    got = dict(add=lambda: F.add(a, b), sub=lambda: F.sub(a, b),
               neg=lambda: F.neg(a), mont_mul=lambda: F.mont_mul(a, b),
               square=lambda: F.square(a), inv=lambda: F.inv(a),
               pow=lambda: F.pow_static(a, 5), encode=lambda: F.encode(std),
               decode=lambda: F.decode(a))[op]()
    assert np.array_equal(got.numpy(), want[op])


def test_edge_values_and_round_trip(field_case):
    F, a, _, std, xs, _ = field_case
    p = F.p
    assert [int(v) for v in F.decode_host(a)] == xs
    assert torch.equal(F.decode(F.encode(std)), std)
    assert torch.equal(F.encode(std), a)
    inv = F.inv(a)
    assert bool((inv[0] == 0).all())                   # inv(0) = 0
    assert int(F.decode_host(inv[1])) == 1
    assert int(F.decode_host(inv[2])) == p - 1          # (-1)^-1 = -1
    assert int(F.decode_host(F.add(a[2], a[1]))) == 0   # (p-1) + 1
    assert int(F.decode_host(F.sub(a[0], a[1]))) == p - 1
    assert bool(F.is_zero(F.mont_mul(a[0], a[2])))


def test_mul_many_equals_separate_products(field_case):
    F, a, b, _, _, _ = field_case
    x, y, z = F.mul_many([(a, b), (a, a), (b, F.const(7))])
    assert torch.equal(x, F.mont_mul(a, b))
    assert torch.equal(y, F.square(a))
    assert torch.equal(z, F.mont_mul(b, F.const(7)))


def test_big_ntt_matches_jax():
    F = BigMontField(P.BN254_FR)
    JF = JBigMontField(JP.BN254_FR, rolled=True)
    n = 16
    w = P.BN254_FR.root_of_unity(n)
    x = F.array(_ints(F.p, 2 * n, 3), "cpu").reshape(2, n, 16)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    fwd, inv = jax.jit(lambda v: (j_big_ntt(JF, v, w),
                                  j_big_intt(JF, v, w)))(jx)
    got = big_ntt(F, x, w)
    assert np.array_equal(got.numpy(), np.asarray(fwd).astype(np.int64))
    assert np.array_equal(big_intt(F, x, w).numpy(),
                          np.asarray(inv).astype(np.int64))
    assert torch.equal(big_intt(F, got, w), x)


def test_params_copy_equals_jax():
    """The port's own copy of the parameters holds the JAX package's
    values."""
    import dataclasses
    for name in ("BN254_FR", "SCALED_FR", "SCALED_FQ"):
        assert (dataclasses.astuple(getattr(P, name))
                == dataclasses.astuple(getattr(JP, name))), name
    assert (dataclasses.astuple(P.SCALED_CURVE)
            == dataclasses.astuple(JP.SCALED_CURVE))
    assert (dataclasses.astuple(P.scaled_plonk_params(1 << 10))
            == dataclasses.astuple(JP.scaled_plonk_params(1 << 10)))
