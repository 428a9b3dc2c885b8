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


# ---- K3's packed twiddles and its schedule, on the CPU ----
# csrc/big_row.cu cannot run here; these hold its index maps (rows of a
# block, the butterfly pairs of each stage, the twiddle entries) against
# the plain row pass.

def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 16) int64 16-bit words."""
    v = packed.long() & 0xFFFFFFFF
    return torch.stack([v & 0xFFFF, v >> 16], dim=-1).flatten(-2)


@pytest.mark.parametrize("C", [2, 8, 128, 1024])
def test_packed_powers_unpack_to_the_row_tables(C):
    """Entry (j mod 2^s) << (S - 1 - s) of the packed powers is the lane
    twiddle _row_tables[s, j] of every stage s and lane j."""
    w = BN254_FR.root_of_unity(C)
    packed = torch.as_tensor(BN._packed_powers(F, w, C))
    tw = torch.as_tensor(BN._row_tables(F, w, C))
    S = C.bit_length() - 1
    assert packed.shape == (C // 2, 8) and packed.dtype == torch.int32
    words = _unpack(packed)
    j = torch.arange(C)
    for s in range(S):
        assert torch.equal(words[(j & ((1 << s) - 1)) << (S - 1 - s)], tw[s])


def _k3_model(y, packed, dif: bool, scale=None):
    """big_row.cu's schedule in PyTorch: blocks of 2^rb rows (256 elements,
    2 a thread), per stage the pairs lo = t with a 0 inserted at bit s and
    hi = lo + 2^s, the twiddle of lo from the packed powers."""
    R, C, L = y.shape
    S = C.bit_length() - 1
    pw = _unpack(packed)
    rb = 0
    while (C << (rb + 1)) <= 256 and (1 << rb) < R:
        rb += 1
    out = []
    for row0 in range(0, R, 1 << rb):
        rows = y[row0:row0 + (1 << rb)]
        el = torch.zeros(((1 << rb) * C, L), dtype=torch.int64)
        el[:rows.shape[0] * C] = rows.reshape(-1, L)
        t = torch.arange(el.shape[0] // 2)
        for k in range(S):
            s = S - 1 - k if dif else k
            lo = ((t >> s) << (s + 1)) | (t & ((1 << s) - 1))
            hi = lo | (1 << s)
            a, b = el[lo], el[hi]
            w = pw[(lo & ((1 << s) - 1)) << (S - 1 - s)]
            if dif:
                el[lo], el[hi] = F.add(a, b), F.mont_mul(F.sub(a, b), w)
            else:
                u = F.mont_mul(b, w)
                el[lo], el[hi] = F.add(a, u), F.sub(a, u)
        if scale is not None:
            el = F.mont_mul(el, scale)
        out.append(el[:rows.shape[0] * C].reshape(-1, C, L))
    return torch.cat(out)


@pytest.mark.parametrize("R,C,dif,scaled", [(5, 2, True, False),
                                            (3, 8, False, True),
                                            (7, 16, True, False),
                                            (3, 128, False, True),
                                            (1, 512, True, False)])
def test_row_pass_schedule_model_matches_plain(R, C, dif, scaled):
    w = BN254_FR.root_of_unity(C)
    y = _rand((R, C), R * C)
    sc = F.const(777) if scaled else None
    got = _k3_model(y, torch.as_tensor(BN._packed_powers(F, w, C)), dif, sc)
    want = BN.big_row_pass_plain(F, y, torch.as_tensor(BN._row_tables(F, w, C)),
                                 dif, sc)
    assert torch.equal(got, want)
