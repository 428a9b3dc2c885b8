"""Parity of the port's matmul transforms (plonk_tpu_torch.ops.mxu_ntt)
and of K7's plain version (`_mont_mat_transform`, behind `mont_matmul` on
a CPU tensor) with the JAX package: its plain-XLA mxu_ntt / mxu_intt and
its Pallas modular matmul (mont_matmul_pallas, mxu_ntt_pallas,
mxu_intt_pallas) run in interpret mode. Exact equality of words."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import mxu_ntt as JMX
from plonk_tpu.ops import pallas_mxu_ntt as JPMX
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops import mxu_ntt as MX
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import MontField

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)


def _mont_words(seed, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return F.encode_host(rng.integers(0, F.p, size=shape))


def _jax(x: np.ndarray):
    return jnp.asarray(x.astype(np.uint32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("log_n", [6, 8])
def test_mxu_transforms_match_jax(log_n):
    """mxu_ntt (forward and inverse root) and mxu_intt against JAX's XLA
    and Pallas versions, and mxu2 (K7's wrapper) against both, batch 3."""
    n = 1 << log_n
    w = SCALED_FR.root_of_unity(n)
    x = _mont_words(log_n, (3, n))
    xt = torch.as_tensor(x)
    y = MX.mxu_ntt(F, xt, w)
    _eq(y, JMX.mxu_ntt(J, _jax(x), w))
    _eq(y, JPMX.mxu_ntt_pallas(J, _jax(x), w, interpret=True))
    _eq(MX.mxu2_ntt(F, xt, w), y.numpy())
    _eq(MX.mxu_ntt(F, xt, w, inverse=True),
        JMX.mxu_ntt(J, _jax(x), w, inverse=True))
    back = MX.mxu_intt(F, y, w)
    _eq(back, JPMX.mxu_intt_pallas(J, _jax(y.numpy()), w, interpret=True))
    _eq(back, JMX.mxu_intt(J, _jax(y.numpy()), w))
    _eq(MX.mxu2_intt(F, y, w), x)
    # transposed layout: the natural transform through mxu_perm
    nat = N.ntt(F, xt, w)
    np.testing.assert_array_equal(y.numpy(), nat.numpy()[:, MX.mxu_perm(n)])


@pytest.mark.parametrize("R,C", [(24, 8), (16, 16)])
@pytest.mark.parametrize("with_tw", [False, True], ids=["plain", "tw"])
def test_mont_matmul_plain_matches_pallas_interpret(R, C, with_tw):
    w = SCALED_FR.root_of_unity(C)
    limbs = MX._dft_limbs(F.p, w, C)
    np.testing.assert_array_equal(limbs, JMX._dft_limbs(F.p, w, C))
    x = _mont_words(R * C, (R, C))
    tw = _mont_words(R + C, (R, C)) if with_tw else None
    want = JPMX.mont_matmul_pallas(
        J, _jax(x), jnp.asarray(limbs), None if tw is None else _jax(tw),
        interpret=True)
    args = (F, torch.as_tensor(x), torch.as_tensor(limbs),
            None if tw is None else torch.as_tensor(tw))
    got = MX._mont_mat_transform(*args)
    _eq(got, want)
    # on a CPU tensor the wrapper is its plain version
    _eq(MX.mont_matmul(*args), got.numpy())
    if with_tw:
        # a (T, K) twiddle serves row r mod T, as the tiled (R, K) table
        half = torch.as_tensor(tw[:R // 2])
        tiled = np.concatenate([tw[:R // 2]] * 2)
        _eq(MX._mont_mat_transform(F, args[1], args[2], half),
            MX._mont_mat_transform(F, args[1], args[2],
                                   torch.as_tensor(tiled)).numpy())


@pytest.mark.parametrize("C,K", [(8, 8), (16, 16), (40, 50)])
def test_kmajor_limbs_match_jax_planes(C, K):
    """K7's K-major copy of the limb planes: the (L, C, K) planes
    transposed to (L, K, C) (JAX's _dft_limbs for the DFT matrix),
    zero-padded to multiples of 32."""
    if K == C:
        w = SCALED_FR.root_of_unity(C)
        limbs = MX._dft_limbs(F.p, w, C)
    else:
        limbs = np.random.default_rng(C + K).integers(
            0, 128, size=(4, C, K)).astype(np.int8)
    km = MX.kmajor_limbs(torch.as_tensor(limbs))
    assert (km.C, km.K) == (C, K)
    got = km.planes.numpy()
    assert got.dtype == np.int8
    assert got.shape == (4, -(-K // 32) * 32, -(-C // 32) * 32)
    np.testing.assert_array_equal(got[:, :K, :C], limbs.transpose(0, 2, 1))
    assert not got[:, K:].any() and not got[:, :, C:].any()
    if K == C:
        np.testing.assert_array_equal(
            got[:, :K, :C], JMX._dft_limbs(J.p, w, C).transpose(0, 2, 1))
        cached = MX._kmajor_on(F.p, w, C, torch.device("cpu"))
        assert (cached.C, cached.K) == (C, K)
        assert torch.equal(cached.planes, torch.as_tensor(got))
    # one form of the planes per path: the CPU's plain version takes the
    # (L, C, K) planes and refuses the K-major copy
    with pytest.raises(TypeError):
        MX.mont_matmul(F, torch.zeros((1, C), dtype=torch.int64), km)


def test_mxu_tables_match_jax():
    n1, n2 = 8, 16
    w = SCALED_FR.root_of_unity(n1 * n2)
    assert MX._n_limbs(F.p) == JMX._n_limbs(J.p)
    assert MX._split(n1 * n2) == JMX._split(n1 * n2)
    np.testing.assert_array_equal(MX.mxu_perm(n1 * n2), JMX.mxu_perm(n1 * n2))
    for inverse in (False, True):
        np.testing.assert_array_equal(
            MX._twiddle_std(F.p, w, n1, n2, inverse),
            JMX._twiddle_std(F.p, w, n1, n2, inverse).astype(np.int64))
