"""Parity of the port's fused four-step transforms
(plonk_tpu_torch.ops.fused_ntt) and of K5's plain version
(plonk_tpu_torch.ops.row_stages.row_transform_plain) with the JAX package:
its fused_ntt / fused_intt / fused_ntt_1k / fused_intt_1k and its Pallas
row_transform, run in interpret mode as tests/test_fused_ntt.py runs them.
Exact equality of words."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import fused_ntt as JFN
from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.ops.pallas_ntt import row_transform as j_row_transform
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops import fused_ntt as FN
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.ops.row_stages import row_transform, row_transform_plain

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)


def _mont_words(seed, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return F.encode_host(rng.integers(0, F.p, size=shape))


def _jax(x: np.ndarray):
    return jnp.asarray(x.astype(np.uint32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("log_n", [6, 8, 10])
@pytest.mark.parametrize("onepass", [False, True], ids=["fused", "1k"])
def test_fused_transforms_match_jax(log_n, onepass):
    """Forward, inverse-root forward and inverse, on a batch of 3."""
    n = 1 << log_n
    w = SCALED_FR.root_of_unity(n)
    x = _mont_words(log_n, (3, n))
    fwd, inv = ((FN.fused_ntt_1k, FN.fused_intt_1k) if onepass
                else (FN.fused_ntt, FN.fused_intt))
    jfwd, jinv = ((JFN.fused_ntt_1k, JFN.fused_intt_1k) if onepass
                  else (JFN.fused_ntt, JFN.fused_intt))
    y = fwd(F, torch.as_tensor(x), w)
    _eq(y, jfwd(J, _jax(x), w, interpret=True))
    _eq(fwd(F, torch.as_tensor(x), w, inverse=True),
        jfwd(J, _jax(x), w, inverse=True, interpret=True))
    back = inv(F, y, w)
    _eq(back, jinv(J, _jax(y.numpy()), w, interpret=True))
    np.testing.assert_array_equal(back.numpy(), x)
    # scrambled layout: the natural transform through scrambled_perm
    nat = N.ntt(F, torch.as_tensor(x), w)
    np.testing.assert_array_equal(y.numpy(),
                                  nat.numpy()[:, FN.scrambled_perm(n)])


@pytest.mark.parametrize("R,C", [(8, 8), (16, 32), (4, 512)])
@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
def test_row_transform_plain_matches_pallas_interpret(R, C, dif):
    w = SCALED_FR.root_of_unity(C)
    tw = F.encode_host(np.stack(JN._stage_tables(F.p, w, C, C)))
    y = _mont_words(R + C, (R, C))
    want = j_row_transform(J.p, J.n_prime, _jax(y), _jax(tw), dif,
                           interpret=True)
    args = (F.p, F.n_prime, torch.as_tensor(y), torch.as_tensor(tw), dif)
    got = row_transform_plain(*args)
    _eq(got, want)
    # on a CPU tensor the wrapper is its plain version
    _eq(row_transform(*args), got.numpy())


def test_tables_and_layout_match_jax():
    n1, n2 = 16, 32
    w = SCALED_FR.root_of_unity(n1 * n2)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            FN._twiddle_matrix(F.p, w, n1, n2, inverse),
            JFN._twiddle_matrix(F.p, w, n1, n2, inverse).astype(np.int64))
    for n in (64, 512):
        np.testing.assert_array_equal(FN.scrambled_perm(n),
                                      JFN.scrambled_perm(n))
