"""K3's transforms on the CPU: the port's big_fused_ntt / big_fused_intt
(whose row passes are big_row_pass_plain on a CPU tensor) against the
JAX package at N = 64 (rows of 8): the forward against its Pallas
transform in interpret mode, as tests/test_pallas_bigntt.py runs it, and
the inverse against JAX's big_intt of the same values in natural order
(the Pallas inverse in interpret mode costs another minute of compile
for the same check). Words are equal (tolerance zero). The card kernel
itself is held against the plain row pass in tests/test_torch_cuda.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
from plonk_tpu.ops.fused_ntt import scrambled_perm as j_scrambled_perm
from plonk_tpu.ops.bigfield import big_intt as j_big_intt
from plonk_tpu.ops.pallas_bigntt import big_fused_ntt as j_fused_ntt
from plonk_tpu.utils.params import BN254_FR as J_BN254_FR
from plonk_tpu_torch.ops import bigntt as BN
from plonk_tpu_torch.ops.bigfield import BigMontField, big_ntt
from plonk_tpu_torch.ops.fused_ntt import scrambled_perm
from plonk_tpu_torch.utils.params import BN254_FR

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

F = BigMontField(BN254_FR)
JF = JBigMontField(J_BN254_FR, rolled=True)
N = 64
W = BN254_FR.root_of_unity(N)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % F.p
            for _ in range(int(np.prod(shape)))]
    return F.array(np.array(vals, dtype=object).reshape(shape), "cpu")


@pytest.fixture(scope="module")
def jax_pair():
    """(input (2, N), JAX's scrambled forward of it, JAX's inverse of it
    read as natural-order evaluations)."""
    x = _rand((2, N), 1)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    fwd = jax.jit(lambda v: j_fused_ntt(JF, v, W, interpret=True))(jx)
    inv = jax.jit(lambda v: j_big_intt(JF, v, W))(jx)
    return x, np.asarray(fwd).astype(np.int64), np.asarray(inv).astype(
        np.int64)


def test_fused_ntt_matches_jax(jax_pair):
    x, fwd, _ = jax_pair
    assert np.array_equal(BN.big_fused_ntt(F, x, W).numpy(), fwd)


def test_fused_intt_matches_jax(jax_pair):
    x, fwd, inv = jax_pair
    # the scrambled layout of x, as the forward leaves evaluations
    xs = x[:, torch.as_tensor(scrambled_perm(N))]
    assert np.array_equal(BN.big_fused_intt(F, xs, W).numpy(), inv)
    assert torch.equal(BN.big_fused_intt(F, torch.as_tensor(fwd), W), x)


@pytest.mark.parametrize("n", [32, 64, 1 << 14])
def test_scrambled_perm_matches_jax(n):
    assert np.array_equal(scrambled_perm(n), j_scrambled_perm(n))


def test_scrambled_layout_is_a_permutation_of_natural():
    x = _rand((N,), 2)
    perm = torch.as_tensor(scrambled_perm(N))
    assert torch.equal(big_ntt(F, x, W)[perm], BN.big_fused_ntt(F, x, W))


@pytest.mark.parametrize("C,dif", [(2, True), (8, False), (16, True)])
def test_row_pass_is_a_size_c_transform(C, dif):
    """One DIF row pass leaves each row's transform in bit-reversed
    order; one DIT pass takes bit-reversed input to natural output."""
    w = BN254_FR.root_of_unity(C)
    rows = _rand((3, C), C)
    tw = torch.as_tensor(BN._row_tables(F, w, C))
    rev = torch.as_tensor(BN._bitrev(C))
    nat = big_ntt(F, rows, w)
    if dif:
        assert torch.equal(BN.big_row_pass_plain(F, rows, tw, True)[:, rev],
                           nat)
    else:
        assert torch.equal(BN.big_row_pass_plain(F, rows[:, rev], tw,
                                                 False), nat)
