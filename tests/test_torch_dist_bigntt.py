"""Parity of the port's sharded 16-limb four-step NTT (plonk_tpu_torch.
parallel.dist_bigntt) with the JAX package on CPU meshes. Exact equality.

- the twiddle blocks equal JAX's `_twiddle_words`;
- dist_big_ntt, dist_big_intt and dist_big_interpolate at n = 64 on 4 and
  8 shards, with and without a batch of 3, equal the port's big_ntt
  (held against JAX in tests/test_torch_bigfield.py) permuted by
  transposed_perm, invert it, and equal big_intt;
- dist_big_ntt at n = 64 on 8 shards equals JAX's dist_big_ntt on its
  8-device CPU mesh. JAX's value takes minutes of shard_map compiles on
  XLA:CPU, so it was recorded once in tests/golden/dist_bn254_jax.json;

      PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
          tests/test_torch_dist_bigntt.py -k recompute

  recomputes and compares it;
- the local transforms' card route (K3's row pass, DIF, then a gather by
  the bit reversal; its plain version here) equals big_ntt at every row
  length of the sharded proofs, on random and edge rows;
- K9's index map (tests/test_torch_collectives.py `_k9_model`) equals the
  plain all_to_all at every 16-limb exchange shape of the sharded proofs.
"""
import json
import os

import numpy as np
import pytest
import torch

from plonk_tpu.parallel import dist_bigntt as JDBN
from plonk_tpu_torch.models.synthetic import big_edge_rows, from_words
from plonk_tpu_torch.ops.bigfield import BigMontField, big_intt, big_ntt
from plonk_tpu_torch.parallel import collectives as CL
from plonk_tpu_torch.parallel import dist_bigntt as DBN
from plonk_tpu_torch.parallel import mesh as MS
from plonk_tpu_torch.parallel.dist_ntt import _split, transposed_perm
from plonk_tpu_torch.utils.params import BN254_FR
from test_torch_collectives import _k9_model

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

F = BigMontField(BN254_FR)
N = 64
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "dist_bn254_jax.json")
with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)


def golden_inputs() -> np.ndarray:
    """The recorded runs' input: N Montgomery words of seeded elements."""
    rng = np.random.default_rng(GOLDEN["seed"])
    return F.encode_host(np.asarray(
        [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(N)],
        dtype=object))


def _values(seed: int, shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % F.p
            for _ in range(int(np.prod(shape)))]
    return torch.as_tensor(F.encode_host(np.asarray(vals, dtype=object))
                           ).reshape(tuple(shape) + (16,))


def _ints(x: torch.Tensor) -> list:
    return [hex(from_words(r)) for r in x.reshape(-1, 16)]


@pytest.mark.parametrize("n,D,inverse", [(64, 8, False), (64, 8, True),
                                         (64, 4, False), (32, 2, True),
                                         (8, 2, False)])
def test_twiddle_words_match_jax(n, D, inverse):
    w = BN254_FR.root_of_unity(n)
    n1, n2 = _split(n, D)
    got = DBN._twiddle_words(F.p, w, n1, n2, D, inverse, 16)
    want = JDBN._twiddle_words(F.p, w, n1, n2, D, inverse, 16)
    assert got.shape == want.shape == (D, n1, n2 // D, 16)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batch3"])
@pytest.mark.parametrize("D", [4, 8])
def test_dist_big_transforms_match_local(D, batch):
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    x = _values(D + len(batch), batch + (N,))
    w = BN254_FR.root_of_unity(N)
    y = MS.unshard_rows(DBN.dist_big_ntt(F, mesh, MS.shard_rows(mesh, x), w))
    perm = torch.as_tensor(transposed_perm(N, D))
    assert torch.equal(y, big_ntt(F, x, w)[..., perm, :])
    back = DBN.dist_big_intt(F, mesh, MS.shard_rows(mesh, y), w)
    assert torch.equal(MS.unshard_rows(back), x)
    interp = DBN.dist_big_interpolate(F, mesh, MS.shard_rows(mesh, x), w)
    assert torch.equal(MS.unshard_rows(interp), big_intt(F, x, w))


def test_dist_big_ntt_matches_recorded_jax():
    mesh = MS.make_1d_mesh("sp", 8, device="cpu")
    x = torch.as_tensor(golden_inputs())
    y = DBN.dist_big_ntt(F, mesh, MS.shard_rows(mesh, x),
                         BN254_FR.root_of_unity(N))
    assert _ints(MS.unshard_rows(y)) == GOLDEN["dist_big_ntt_n64_d8"]


# the local transforms' lengths: n1 and n2 of n = 8 and 4n = 32 on 2
# shards, of n = 64 on 4 and 8, of 2^12 and 2^14 on 8 shards
@pytest.mark.parametrize("C", [2, 4, 8, 16, 64, 128])
def test_row_route_matches_big_ntt(C):
    """The card's local transform (K3's row pass from natural order, then
    the bit-reversal gather; here the row pass's plain version) gives
    big_ntt's words, on random rows and on the edge rows K3 is held to
    (zeros, p - 1, first-stage sums landing on p)."""
    w = BN254_FR.root_of_unity(C)
    rng = np.random.default_rng(C)
    for x in (_values(C, (5, C)),
              torch.as_tensor(big_edge_rows(F.p, 10, C, True, rng))):
        assert torch.equal(DBN._row_ntt(F, x, w), big_ntt(F, x, w))
    inv = pow(w, -1, F.p)
    x = _values(C + 1, (3, 2, C))
    assert torch.equal(DBN._row_ntt(F, x, inv), big_ntt(F, x, inv))


def _limb_cases():
    """(D, shard shape, split, concat) of every all_to_all of the sharded
    n = 8 proof on 2 shards and of the 2^12 proof on 8 (interpolations of
    batch 9, 4 and none; coset transforms of batch 10, 6 and none), and at
    the batch of 12."""
    cases = []
    for n, D in ((8, 2), (1 << 12, 8)):
        for size, batches in ((n, (9, 4, 12, None)),
                              (4 * n, (10, 6, 12, None))):
            n1, n2 = _split(size, D)
            for b in batches:
                lead = () if b is None else (b,)
                k = len(lead)
                cases += [(D, lead + (n1 // D, n2, 16), k + 1, k),
                          (D, lead + (n1, n2 // D, 16), k, k + 1)]
    return cases


@pytest.mark.parametrize("D,shape,split_axis,concat_axis", _limb_cases())
def test_a2a_plan_at_the_limb_shapes(D, shape, split_axis, concat_axis):
    """K9's host plan takes the trailing 16-word axis (it merges into the
    runs), and its index map moves every word as all_to_all_plain does."""
    plan = CL.a2a_plan(shape, D, split_axis, concat_axis)
    assert plan.run % 16 == 0
    g = torch.Generator().manual_seed(sum(shape))
    shards = [torch.randint(0, 1 << 16, shape, generator=g)
              for _ in range(D)]
    for a, b in zip(_k9_model(shards, split_axis, concat_axis),
                    CL.all_to_all_plain(shards, split_axis, concat_axis),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="compiles JAX's sharded transform (~1-2 minutes "
                           "of XLA:CPU); set PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values():
    import jax.numpy as jnp
    from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
    from plonk_tpu.parallel.mesh import make_1d_mesh
    y = np.asarray(JDBN.dist_big_ntt(
        JBigMontField(BN254_FR), make_1d_mesh("sp", 8),
        jnp.asarray(golden_inputs().astype(np.uint32)),
        BN254_FR.root_of_unity(N)))
    got = [hex(from_words(r)) for r in y]
    print(json.dumps({"dist_big_ntt_n64_d8": got}))
    assert got == GOLDEN["dist_big_ntt_n64_d8"]
