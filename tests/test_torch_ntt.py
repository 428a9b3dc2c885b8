"""Parity of the port's NTT (plonk_tpu_torch.ops.ntt) and of K1's plain
version (plonk_tpu_torch.ops.row_stages) with the JAX package: the XLA
transforms of plonk_tpu.ops.ntt, and the Pallas row-stage kernel run in
interpret mode, as tests/test_pallas_ntt.py runs it. Exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.ops.pallas_ntt import row_stages as j_row_stages
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.ops.row_stages import row_stages, row_stages_plain

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, F.p, size=shape).astype(np.int64)


@pytest.mark.parametrize("n,batch", [(16, ()), (16, (3,)), (4096, ()),
                                     (4096, (3,))])
def test_ntt_intt_match_jax(n, batch):
    rng = np.random.default_rng(n + len(batch))
    x = _words(rng, batch + (n,))
    w = SCALED_FR.root_of_unity(n)
    jx = jnp.asarray(x.astype(np.uint32))
    got = N.ntt(F, torch.as_tensor(x), w)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JN.ntt(J, jx, w), np.int64))
    back = N.intt(F, got, w)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        N.intt(F, torch.as_tensor(x), w).numpy(),
        np.asarray(JN.intt(J, jx, w), np.int64))


@pytest.mark.parametrize("R,C", [(16, 256), (8, 1024)])
def test_row_stages_plain_matches_pallas_interpret(R, C):
    n = R * C
    w = SCALED_FR.root_of_unity(n)
    tables = JN._stage_tables(F.p, w, n, C)
    n_intra = C.bit_length() - 1
    tw = F.encode_host(np.stack(tables[:n_intra]))
    y = F.encode_host(_words(np.random.default_rng(R), (R, C)))
    want = j_row_stages(J.p, J.n_prime, jnp.asarray(y.astype(np.uint32)),
                        jnp.asarray(tw.astype(np.uint32)), block_rows=8,
                        interpret=True)
    args = (F.p, F.n_prime, torch.as_tensor(y), torch.as_tensor(tw))
    got = row_stages_plain(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    # on a CPU tensor the wrapper is its plain version
    np.testing.assert_array_equal(row_stages(*args).numpy(), got.numpy())


def test_stage_tables_match_jax():
    n, C = 1 << 13, 1024
    w = SCALED_FR.root_of_unity(n)
    for got, want in zip(N._stage_tables(F.p, w, n, C),
                         JN._stage_tables(J.p, w, n, C)):
        np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(N._bit_reverse_perm(n),
                                  JN._bit_reverse_perm(n))
