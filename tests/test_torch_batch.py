"""The port's batched toy prover (parallel/batch.py) against the JAX
package's make_batched_prover, the port's single proofs and the port's
sharded prover on a 2-shard CPU mesh: word for word, diagnostics
included (tolerance 0).

The configuration is that of the JAX package's entry(): the canonical
circuit and witness in every lane, the fixed SRS, the reference dialect.
Lanes 0-3 are tests/test_parallel.py's (varied challenges; with lane 1's
the reference dialect's r3 term is live and srs_fit is false, which the
batch must not filter). Lanes 4-255 draw challenges and blinding from a
seed, so some have z in H, or a zero grand-product denominator, where
division gives 0 and the diagnostics fail; lanes 4-8 force z in H and 0.
JAX's values come from one compiled call on all 256 lanes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.models import presets as JPRS
from plonk_tpu.parallel import batch as JB
from plonk_tpu_torch.models import plonk as PL
from plonk_tpu_torch.models.constraints import constraints_to_tensors
from plonk_tpu_torch.models.presets import (
    CANONICAL_CHALLENGE, CANONICAL_RAND, canonical_assignments,
    canonical_constraints, canonical_context)
from plonk_tpu_torch.parallel import batch as B
from plonk_tpu_torch.parallel import mesh as MS

N_LANES = 256


def _lanes():
    rng = np.random.default_rng(2024)
    chs = rng.integers(0, 17, size=(N_LANES, 5))
    rnds = rng.integers(0, 17, size=(N_LANES, 9))
    chs[0] = chs[3] = CANONICAL_CHALLENGE
    chs[1] = [3, 7, 11, 2, 6]
    chs[2] = [1, 1, 2, 3, 5]
    rnds[:4] = CANONICAL_RAND
    chs[4:9, 3] = [1, 4, 16, 13, 0]          # z on H = {1, 4, 16, 13}, and 0
    asg = canonical_assignments()
    wires = [np.tile(w, (N_LANES, 1)) for w in (asg.a, asg.b, asg.c)]
    return wires, chs, rnds


def _ints(x):
    return np.asarray(x).astype(np.int64)


def assert_lanes_equal(p, d, q, e, lanes):
    """Proof/diagnostics batches (p, d) equal (q, e) on `lanes`."""
    for f in PL.POINT_FIELDS:
        for k in range(3):
            np.testing.assert_array_equal(
                _ints(getattr(p, f)[k])[lanes], _ints(getattr(q, f)[k])[lanes],
                f)
    for f in PL.SCALAR_FIELDS:
        np.testing.assert_array_equal(_ints(getattr(p, f))[lanes],
                                      _ints(getattr(q, f))[lanes], f)
    for f in PL.Diagnostics._fields:
        np.testing.assert_array_equal(np.asarray(getattr(d, f))[lanes],
                                      np.asarray(getattr(e, f))[lanes], f)


def assert_single_proofs_equal(ctx, chs, rnds, proofs, diags, lanes):
    """The port's single proof of each lane equals the batch's lane."""
    cons, asg = canonical_constraints(), canonical_assignments()
    for lane in lanes:
        p, d = PL.prove(ctx, cons, asg, chs[lane], rnds[lane])
        for f in PL.POINT_FIELDS:
            for k in range(3):
                assert int(getattr(p, f)[k]) == \
                    int(getattr(proofs, f)[k][lane]), (lane, f)
        for f in PL.SCALAR_FIELDS:
            assert int(getattr(p, f)) == int(getattr(proofs, f)[lane]), \
                (lane, f)
        assert [bool(x) for x in d] == [bool(x[lane]) for x in diags]


@pytest.fixture(scope="module")
def setup():
    ctx = canonical_context(srs_mode="fixed", device="cpu")
    sel, cp = constraints_to_tensors(canonical_constraints())
    wires, chs, rnds = _lanes()
    jctx = JPRS.canonical_context(srs_mode="fixed")
    jfn = jax.jit(JB.make_batched_prover(jctx, jnp.asarray(
        sel.astype(np.uint32)), jnp.asarray(cp)))
    jproofs, jdiags = jfn(*(jnp.asarray(x.astype(np.uint32))
                            for x in (*wires, chs, rnds)))
    return ctx, sel, cp, wires, chs, rnds, (jproofs, jdiags)


def test_b4_equals_jax_and_single_proofs(setup):
    ctx, sel, cp, wires, chs, rnds, (jproofs, jdiags) = setup
    args = [x[:4] for x in (*wires, chs, rnds)]
    proofs, diags = B.make_batched_prover(ctx, sel, cp)(*args)
    assert proofs.r_z.shape == (4,) and proofs.a_s.x.shape == (4,)
    assert_lanes_equal(proofs, diags, jproofs, jdiags, slice(0, 4))
    assert bool(diags.satisfied.all()) and bool(diags.t_rem_zero.all())
    assert not bool(diags.srs_fit[1])                 # kept, not filtered
    assert not bool(diags.all_ok())
    assert_single_proofs_equal(ctx, chs, rnds, proofs, diags, range(4))
    # lanes 0 and 3 are the canonical proof
    assert [int(proofs.r_z[i]) for i in (0, 3)] == [15, 15]
    sharded = B.make_sharded_prover(
        ctx, sel, cp, MS.make_1d_mesh("dp", 2, device="cpu"))(*args)
    assert_lanes_equal(*sharded, proofs, diags, slice(0, 4))


def test_b256_equals_jax_single_and_sharded(setup):
    ctx, sel, cp, wires, chs, rnds, (jproofs, jdiags) = setup
    args = (*wires, chs, rnds)
    proofs, diags = B.make_batched_prover(ctx, sel, cp)(*args)
    everything = slice(0, N_LANES)
    assert_lanes_equal(proofs, diags, jproofs, jdiags, everything)
    sharded = B.make_sharded_prover(
        ctx, sel, cp, MS.make_1d_mesh("dp", 2, device="cpu"))(*args)
    assert_lanes_equal(*sharded, proofs, diags, everything)

    # the seeded lanes reach the edges: z in H, zero denominators of the
    # grand product's fractions (a + beta * sigma + gamma = 0 on a row)
    d = {f: np.asarray(getattr(diags, f)) for f in PL.Diagnostics._fields}
    assert np.isin(chs[:, 3], [1, 4, 16, 13]).sum() >= 4
    sigmas = np.stack([PL.sigma_to_roots(ctx, c).numpy()[:3]
                       for c in cp])                        # (3, n - 1)
    beta, gamma = chs[:, 1, None, None], chs[:, 2, None, None]
    w = np.stack([x[:, :3] for x in wires], axis=1)         # (B, 3, n - 1)
    zero_den = ((w + beta * sigmas + gamma) % 17 == 0).any(axis=(1, 2))
    assert zero_den.sum() >= 4
    assert (~d["t_rem_zero"]).any() and (~d["srs_fit"]).any()
    assert d["satisfied"].all()

    # single proofs: the first lanes, the forced ones, and one lane of
    # every diagnostics pattern the batch shows
    patterns = {}
    for lane in range(N_LANES):
        patterns.setdefault(tuple(v[lane] for v in d.values()), lane)
    lanes = sorted(set(range(10)) | set(patterns.values()))
    assert len(patterns) >= 3
    assert_single_proofs_equal(ctx, chs, rnds, proofs, diags, lanes)


def test_sharded_prover_checks_its_mesh(setup):
    """Any batch splits, as JAX's sharding constraint allows: B = 3 on 2
    shards, B = 6 on 4 (slices of 2, 2, 1, 1) and B = 3 on 4 (an empty
    slice) equal the batched prover lane for lane; the mesh's axis and
    devices are checked."""
    ctx, sel, cp, wires, chs, rnds, _ = setup
    for nb, D in ((3, 2), (6, 4), (3, 4)):
        args = [x[4:4 + nb] for x in (*wires, chs, rnds)]
        proofs, diags = B.make_batched_prover(ctx, sel, cp)(*args)
        sharded = B.make_sharded_prover(
            ctx, sel, cp, MS.make_1d_mesh("dp", D, device="cpu"))(*args)
        assert sharded[0].r_z.shape == (nb,)
        assert_lanes_equal(*sharded, proofs, diags, slice(0, nb))
    with pytest.raises(ValueError, match="axis"):
        B.make_sharded_prover(ctx, sel, cp,
                              MS.make_1d_mesh("sp", 2, device="cpu"))
    with pytest.raises(ValueError, match="devices"):
        B.make_sharded_prover(ctx, sel, cp,
                              MS.Mesh("dp", (torch.device("meta"),)))
