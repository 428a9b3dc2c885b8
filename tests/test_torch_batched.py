"""Batched proving in the port (plonk_tpu_torch): prove_scaled /
make_prover and prove_bn254 / make_prover_bn254 with a leading batch
axis, and both Poseidon `prove_many` as one batched pass, against the JAX
package's vmapped provers, on the CPU. Every comparison is exact, word for
word, nonce, challenge and per-lane diagnostics included.

- Scaled curve, n = 16, B = 3 (bench.py's bench_scaled_batched inputs):
  witnesses square_chain_circuit(r, 16, x0=3+i), challenges 1111..5555,
  blinding 1..9 + 100 i mod r, lane 1's c[5] off by one. Without public
  inputs, and with gate 0 rebound to a[0] + PI[0] = 0 and per-lane public
  inputs. Lanes equal JAX's jax.jit(jax.vmap(prove_scaled)) and the
  port's own single proofs; B = 1 in batched form equals the unbatched
  proof; verify_scaled_many accepts the good lanes and refuses lane 1.
  fused/onepass/mxu/mxu2 prims batch (lanes equal the default prims');
  the mesh prims refuse a batch.
- Scaled Poseidon prove_many, n = 16, B = 3 (good witnesses): lanes equal
  JAX's PoseidonFsProver.prove_many, without and with per-lane public
  inputs (the circuit with gate 0 rebound, as above); with them each lane
  also equals prove() of its inputs, and lane 0 verifies with its own
  public inputs and not with lane 1's; a refusal forced in lane 1 at nonce
  0 gives it nonce 1 and leaves the other lanes as they were; a lane
  refused at every nonce raises after 33 attempts.
- BN254, n = 8, B = 2: witnesses bn254_mul_circuit(8, seed=11+i),
  challenges [111111 ..] and [666666 ..], rand9 17..25 and 31..39. Lanes
  equal JAX's vmapped prove_bn254 and the single proofs (lane 0 is the
  recorded proof of tests/test_torch_bn254.py). BN254PoseidonFsProver.
  prove_many, one batched pass, equals JAX's lanes recorded in
  tests/golden/bn254_fs_jax.json in tests/test_torch_bn254_fs.py
  (test_prove_many_matches_recorded_jax: its 30 16-limb permutations take
  ~30 s on the CPU, so this file does not run them again); here a forced
  refusal in one lane, with that file's cheap stand-in sponge, takes the
  next nonce in that lane only, and a lane refused at every nonce
  raises.

JAX's vmapped provers compile for minutes on XLA:CPU (the scaled one
~2 minutes, the BN254 one and the Poseidon prove_many far longer), so
their values were recorded once in tests/golden/batched_jax.json, by the
same JAX calls as

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_batched.py -k recompute

which recomputes them, carries JAX's vmapped outputs across with
utils/convert.py, and compares.
"""
import json
import os

import numpy as np
import pytest
import torch

from plonk_tpu_torch.models import fs_poseidon as FSP
from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.synthetic import (bn254_mul_circuit, from_words,
                                              square_chain_circuit,
                                              words_vec)
from plonk_tpu_torch.ops import poseidon as PO
from plonk_tpu_torch.parallel.mesh import make_1d_mesh
from plonk_tpu_torch.parallel.dist_prover import make_dist_prims
from plonk_tpu_torch.utils import convert
from plonk_tpu_torch.utils.params import BN254_FR, SCALED_FR
from test_torch_bn254 import JAX_POINTS, JAX_SCALARS
from test_torch_bn254_fs import fs_fields as bn254_fs_fields
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

R = SCALED_FR.p
N, B = 16, 3
BAD = 1                     # the lane whose witness is wrong
CH = [1111, 2222, 3333, 4444, 5555]
NB, BB = 8, 2               # the BN254 batch
SECRET_BN = 987654321
BN_CH = [[111111, 222222, 333333, 444444, 555555],
         [666666, 777777, 888888, 999999, 1234567]]
BN_RND = [range(17, 26), range(31, 40)]
heavy = pytest.mark.skipif(
    not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
    reason="compiles JAX's vmapped provers (minutes to tens of minutes of "
           "XLA:CPU); set PLONK_TPU_HEAVY_TESTS=1")

with open(os.path.join(os.path.dirname(__file__), "golden",
                       "batched_jax.json")) as _f:
    GOLDEN = json.load(_f)


# ---- inputs (shared by the port and the JAX side) ----

def scaled_inputs(pi: bool, bad: bool = True):
    """(sel, copies, a, b, c, challenges, rand9, public inputs or None) of
    the scaled batch, standard-form numpy arrays."""
    sel, cp = square_chain_circuit(R, N)[:2]
    wits = [square_chain_circuit(R, N, x0=3 + i)[2:] for i in range(B)]
    a, b, c = (np.stack([w[k] for w in wits]).astype(np.int64)
               for k in range(3))
    if bad:
        c[BAD, 5] = (c[BAD, 5] + 1) % R
    chs = np.tile(np.array(CH, dtype=np.int64), (B, 1))
    rnds = (np.arange(1, 10) + 100 * np.arange(B)[:, None]) % R
    pis = None
    if pi:
        sel = np.array(sel)
        sel[:, 0] = 0
        sel[0, 0] = 1                       # gate 0: a[0] + PI[0] = 0
        pis = np.zeros((B, N), dtype=np.int64)
        pis[:, 0] = (R - a[:, 0]) % R
    return sel, cp, a, b, c, chs, rnds, pis


def bn254_inputs():
    """(sel, copies, a, b, c, challenges, rand9) of the BN254 batch as
    standard-form word arrays."""
    circuits = [bn254_mul_circuit(NB, seed=11 + i) for i in range(BB)]
    sel, cp = circuits[0][:2]
    a, b, c = (np.stack([ci[2 + k] for ci in circuits]) for k in range(3))
    return (sel, cp, a, b, c, np.stack([words_vec(v) for v in BN_CH]),
            np.stack([words_vec(v) for v in BN_RND]))


# ---- lanes as plain values (from the port's tensors or JAX's arrays) ----

def _plain(x):
    return json.loads(json.dumps(x))


def scaled_lanes(proof, diags) -> list:
    """One dict a lane: points [x, y, inf], evaluations and the four
    diagnostic flags."""
    a = lambda t: np.asarray(t)
    return _plain([dict(
        {k: [int(a(getattr(proof, k).x)[i]), int(a(getattr(proof, k).y)[i]),
             bool(a(getattr(proof, k).inf)[i])] for k in POINT_FIELDS},
        **{k: int(a(getattr(proof, k))[i]) for k in SCALAR_FIELDS},
        diags=[bool(a(f)[i]) for f in diags])
        for i in range(len(a(proof.r_z)))])


def fs_lane(out, diags) -> dict:
    """A scaled PoseidonFsProof with its diagnostics as plain values."""
    lane = scaled_lanes(PS.stack_proofs([convert.proof_from_numpy(
        out.proof, "cpu")]), [np.asarray(f)[None] for f in diags])[0]
    lane.update(nonce=int(out.nonce),
                challenge=[int(x) for x in np.asarray(out.challenge)])
    return lane


def bn254_lanes(proof, diags) -> list:
    """One dict a lane: points [x, y, inf] and evaluations as hex strings
    of their standard-form words, and the four flags."""
    a = lambda t: np.asarray(t)
    h = lambda w: hex(from_words(w))
    return _plain([dict(
        {k: [h(a(getattr(proof, k).x)[i]), h(a(getattr(proof, k).y)[i]),
             bool(a(getattr(proof, k).inf)[i])] for k in PB.POINT_FIELDS},
        **{k: h(a(getattr(proof, k))[i]) for k in PB.SCALAR_FIELDS},
        diags=[bool(a(f)[i]) for f in diags])
        for i in range(BB)])


# ---- the JAX side (run by the recompute tests) ----

def jax_scaled(pi: bool):
    """JAX's jax.jit(jax.vmap(prove_scaled)) on the scaled batch -> the
    port's stacked proof and diagnostics (carried across)."""
    import jax
    import jax.numpy as jnp
    from plonk_tpu.models import plonk_scaled as JPS
    sel, cp, a, b, c, chs, rnds, pis = scaled_inputs(pi)
    ctx = JPS.scaled_new(N)
    u32 = lambda x: jnp.asarray(np.asarray(x), jnp.uint32)
    sel_j, cp_j = u32(sel), jnp.asarray(cp)
    args = [u32(x) for x in (a, b, c, chs, rnds)]
    if pi:
        one = lambda a1, b1, c1, ch1, r1, pi1: JPS.prove_scaled(
            ctx, sel_j, cp_j, a1, b1, c1, ch1, r1, public_inputs=pi1)
        args.append(u32(pis))
    else:
        one = lambda a1, b1, c1, ch1, r1: JPS.prove_scaled(
            ctx, sel_j, cp_j, a1, b1, c1, ch1, r1)
    proof, diags = jax.device_get(jax.jit(jax.vmap(one))(*args))
    return (convert.proof_from_numpy(proof, "cpu"),
            convert.scaled_diagnostics_from_numpy(diags, "cpu"))


def jax_fs_poseidon(pi: bool = False) -> list:
    from plonk_tpu.models import fs_poseidon as JFSP
    from plonk_tpu.models import plonk_scaled as JPS
    sel, cp, a, b, c, _, rnds, pis = scaled_inputs(pi, bad=False)
    u32 = lambda x: np.asarray(x).astype(np.uint32)
    outs = JFSP.PoseidonFsProver(JPS.scaled_new(N), sel, cp).prove_many(
        u32(a), u32(b), u32(c), u32(rnds),
        public_inputs=None if pis is None else u32(pis))
    return [fs_lane(out, d) for out, d in outs]


def jax_bn254():
    """JAX's jax.jit(jax.vmap(prove_bn254)) on the BN254 batch -> the
    port's stacked proof and diagnostics."""
    import jax
    import jax.numpy as jnp
    from plonk_tpu.models import plonk_bn254 as JPB
    sel, cp, a, b, c, chs, rnds = bn254_inputs()
    ctx = JPB.bn254_setup(NB, secret=SECRET_BN, rolled=True)
    u32 = lambda x: jnp.asarray(np.asarray(x), jnp.uint32)
    one = lambda a1, b1, c1, ch1, r1: JPB.prove_bn254(
        ctx, u32(sel), jnp.asarray(cp), a1, b1, c1, ch1, r1)
    proof, diags = jax.device_get(jax.jit(jax.vmap(one))(
        *(u32(x) for x in (a, b, c, chs, rnds))))
    return (convert.bn254_proof_from_numpy(proof, "cpu"),
            convert.bn254_diagnostics_from_numpy(diags, "cpu"))


# ---- the port ----

@pytest.fixture(scope="module", autouse=True)
def _inference():
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def scaled_ctx():
    return PS.scaled_new(N, device="cpu")


@pytest.fixture(scope="module", params=[False, True], ids=["no_pi", "pi"])
def scaled(request, scaled_ctx):
    """The port's batched proof of the scaled batch, with its prover."""
    pi = request.param
    sel, cp, a, b, c, chs, rnds, pis = scaled_inputs(pi)
    prover = PS.make_prover(scaled_ctx, sel, cp)
    proof, diags = prover(a, b, c, chs, rnds, public_inputs=pis)
    return dict(pi=pi, prover=prover, inputs=(sel, cp, a, b, c, chs, rnds,
                                              pis),
                proof=proof, diags=diags)


def test_scaled_batch_matches_jax(scaled):
    got = scaled_lanes(scaled["proof"], scaled["diags"])
    assert got == GOLDEN["scaled_pi" if scaled["pi"] else "scaled"]
    # the wrong witness fails alone, in its own lane
    assert [lane["diags"][0] for lane in got] == [i != BAD for i in range(B)]
    assert not bool(scaled["diags"].all_ok())


def test_scaled_batch_lanes_match_single_proofs(scaled):
    _, _, a, b, c, chs, rnds, pis = scaled["inputs"]
    got = scaled_lanes(scaled["proof"], scaled["diags"])
    for i in range(B):
        proof, diags = scaled["prover"](
            a[i], b[i], c[i], chs[i], rnds[i],
            public_inputs=None if pis is None else pis[i])
        one = scaled_lanes(PS.stack_proofs([proof]),
                           [f[None] for f in diags])[0]
        assert one == got[i]


def test_scaled_b1_batched_equals_unbatched(scaled):
    _, _, a, b, c, chs, rnds, pis = scaled["inputs"]
    i = 2
    batched, bd = scaled["prover"](
        a[i:i + 1], b[i:i + 1], c[i:i + 1], chs[i:i + 1], rnds[i:i + 1],
        public_inputs=None if pis is None else pis[i:i + 1])
    single, sd = scaled["prover"](
        a[i], b[i], c[i], chs[i], rnds[i],
        public_inputs=None if pis is None else pis[i])
    assert bd.satisfied.shape == (1,) and sd.satisfied.shape == ()
    assert scaled_lanes(batched, bd) == scaled_lanes(
        PS.stack_proofs([single]), [f[None] for f in sd])


def test_scaled_verify_many_accepts_the_good_lanes(scaled, scaled_ctx):
    sel, cp, _, _, _, chs, _, pis = scaled["inputs"]
    vk = PS.make_vk_scaled(scaled_ctx, sel, cp)
    flags = PS.verify_scaled_many(scaled_ctx, vk, scaled["proof"], chs,
                                  public_inputs=pis)
    assert flags.tolist() == [i != BAD for i in range(B)]


def test_scaled_checked_prover_takes_a_batch(scaled_ctx):
    """prove_scaled_checked raises when any lane fails a check (lane 1's
    wrong witness), and gives the batch when none does."""
    sel, cp, a, b, c, chs, rnds, _ = scaled_inputs(False)
    with pytest.raises(ValueError, match="does not satisfy"):
        PS.prove_scaled_checked(scaled_ctx, sel, cp, a, b, c, chs, rnds)
    good = [0, 2]
    proof, diags = PS.prove_scaled_checked(
        scaled_ctx, sel, cp, a[good], b[good], c[good], chs[good],
        rnds[good])
    assert scaled_lanes(proof, diags) == [GOLDEN["scaled"][i] for i in good]


@pytest.mark.parametrize("name", ["fused", "onepass", "mxu", "mxu2"])
def test_scaled_batch_under_other_prims(scaled_ctx, name):
    """The other prims' transforms take leading dims, so they batch: the
    lanes equal the default prims' (n = 16 on the CPU, plain versions)."""
    sel, cp, a, b, c, chs, rnds, _ = scaled_inputs(False)
    prims = PS._PRIMS[name]()
    got = PS.make_prover(scaled_ctx, sel, cp, prims=prims)(a, b, c, chs,
                                                            rnds)
    assert scaled_lanes(*got) == GOLDEN["scaled"]


def test_mesh_prims_refuse_a_batch(scaled_ctx):
    sel, cp, a, b, c, chs, rnds, _ = scaled_inputs(False)
    prims = make_dist_prims(scaled_ctx, make_1d_mesh("sp", 2, device="cpu"))
    with pytest.raises(ValueError, match="queue 1 item 10"):
        PS.prove_scaled(scaled_ctx, sel, cp, a, b, c, chs, rnds,
                        prims=prims)


# ---- the batched helpers under the provers ----

def test_prefix_prod_lanes(scaled_ctx):
    """The chunked prefix product (taken from 4096 elements, the grand
    product at 2^16) and the doubling scan, per lane of a (3, L) batch."""
    from plonk_tpu_torch.ops import poly as P
    Fr = scaled_ctx.Fr
    x = Fr.encode(torch.as_tensor(np.random.default_rng(4).integers(
        0, R, size=(3, 4100))))
    got = PS._prefix_prod(Fr, x)
    for i in range(3):
        assert torch.equal(got[i], PS._prefix_prod(Fr, x[i]))
        assert torch.equal(got[i], P.scan(Fr.mul, x[i]))
    acc = PS._local_grand_product(Fr, x[:, :100])
    assert acc.shape == (3, 101)
    assert torch.equal(acc[1], PS._local_grand_product(Fr, x[1, :100]))


def test_tree_digests_lanes(scaled_ctx, bn_ctx):
    """tree_digest and big_tree_digest of (B, m) leaves, per lane."""
    Fr, Fb = scaled_ctx.Fr, bn_ctx.Fr
    pos, pos_b = PO.make_params(R), PO.make_params(BN254_FR.p, t=3)
    leaves = torch.as_tensor(np.random.default_rng(5).integers(
        0, R, size=(3, 16)))
    got = PO.tree_digest(Fr, pos, leaves)
    assert got.shape == (3,)
    assert all(torch.equal(got[i], PO.tree_digest(Fr, pos, leaves[i]))
               for i in range(3))
    big = torch.as_tensor(words_vec(range(1, 9)).reshape(2, 4, 16)
                          .astype(np.int64))
    got = PO.big_tree_digest(Fb, pos_b, big)
    assert got.shape == (2, 16)
    assert all(torch.equal(got[i], PO.big_tree_digest(Fb, pos_b, big[i]))
               for i in range(2))


def test_batch_inv_lanes(bn_ctx):
    """The 16-limb Montgomery-trick inverse of (B, n, 16), zeros
    included, per lane and equal to Fermat's inverse."""
    from plonk_tpu_torch.ops import bigpoly as BPol
    Fr = bn_ctx.Fr
    a = Fr.encode(torch.as_tensor(words_vec(
        [0, 5, 7, 11, 13, 0, 17, 19]).reshape(2, 4, 16).astype(np.int64)))
    got = BPol.batch_inv(Fr, a)
    for i in range(2):
        assert torch.equal(got[i], BPol.batch_inv(Fr, a[i]))
    assert torch.equal(got, Fr.inv(a))


# ---- scaled Poseidon prove_many ----

@pytest.fixture(scope="module")
def fs_scaled(scaled_ctx):
    sel, cp, a, b, c, _, rnds, _ = scaled_inputs(False, bad=False)
    return FSP.PoseidonFsProver(scaled_ctx, sel, cp), (a, b, c, rnds)


@pytest.fixture(scope="module")
def fs_scaled_pi(scaled_ctx):
    """The prover of the public-input circuit, with per-lane public
    inputs."""
    sel, cp, a, b, c, _, rnds, pis = scaled_inputs(True, bad=False)
    return FSP.PoseidonFsProver(scaled_ctx, sel, cp), (a, b, c, rnds, pis)


def _refuse(real, lanes, calls, first_only=True):
    """_stage_grand_product with the denominator refused in `lanes` (a
    bool mask) at the first call (every call with first_only=False)."""
    def stage(*args):
        z_x, ok = real(*args)
        calls.append(1)
        if len(calls) == 1 or not first_only:
            ok = ok & ~torch.as_tensor(lanes)
        return z_x, ok
    return stage


def test_fs_poseidon_prove_many_matches_jax(fs_scaled):
    prover, inputs = fs_scaled
    outs = prover.prove_many(*inputs)
    assert [fs_lane(*o) for o in outs] == GOLDEN["scaled_fs_poseidon"]
    assert [o.nonce for o, _ in outs] == [0] * B


def test_fs_poseidon_prove_many_with_public_inputs(fs_scaled_pi,
                                                  scaled_ctx):
    """Per-lane public inputs: the lanes equal JAX's prove_many with them
    and prove() of each lane with its own; lane 0 verifies with its public
    inputs and not with lane 1's."""
    prover, (a, b, c, rnds, pis) = fs_scaled_pi
    outs = prover.prove_many(a, b, c, rnds, public_inputs=pis)
    lanes = [fs_lane(*o) for o in outs]
    assert lanes == GOLDEN["scaled_fs_poseidon_pi"]
    for i in range(B):
        assert fs_lane(*prover.prove(a[i], b[i], c[i], rnds[i],
                                     public_inputs=pis[i])) == lanes[i]
    vk = prover.vk
    assert FSP.verify_scaled_fs_poseidon(scaled_ctx, vk, outs[0][0],
                                         public_inputs=pis[0])
    assert not FSP.verify_scaled_fs_poseidon(scaled_ctx, vk, outs[0][0],
                                             public_inputs=pis[1])


def test_fs_poseidon_prove_many_needs_a_batch_axis(fs_scaled, monkeypatch):
    """(n,) witness columns are refused before any stage runs."""
    prover, (a, b, c, rnds) = fs_scaled
    monkeypatch.setattr(PS, "_stage_prep",
                        lambda *args: pytest.fail("a stage ran"))
    with pytest.raises(ValueError, match="leading batch axis"):
        prover.prove_many(a[0], b[0], c[0], rnds[0])


def test_fs_poseidon_refusal_in_one_lane(fs_scaled, scaled_ctx,
                                         monkeypatch):
    """Lane 1 refused at nonce 0: it takes nonce 1 (its challenges are the
    host replay's at nonce 1, and it equals prove() of its inputs refused
    once), the other lanes stay JAX's; one stage call a nonce."""
    prover, (a, b, c, rnds) = fs_scaled
    real = PS._stage_grand_product
    calls = []
    mask = [i == 1 for i in range(B)]
    monkeypatch.setattr(PS, "_stage_grand_product",
                        _refuse(real, mask, calls))
    outs = prover.prove_many(a, b, c, rnds)
    assert len(calls) == 2
    assert [o.nonce for o, _ in outs] == [0, 1, 0]
    lanes = [fs_lane(*o) for o in outs]
    want = GOLDEN["scaled_fs_poseidon"]
    assert lanes[0] == want[0] and lanes[2] == want[2]
    assert lanes[1] != want[1] and all(lanes[1]["diags"])
    np.testing.assert_array_equal(FSP.derive_challenges_host(
        scaled_ctx, list(prover.vk), outs[1][0].proof, 1),
        outs[1][0].challenge)
    calls.clear()
    monkeypatch.setattr(PS, "_stage_grand_product",
                        _refuse(real, True, calls))
    assert fs_lane(*prover.prove(a[1], b[1], c[1], rnds[1])) == lanes[1]


def test_fs_poseidon_lane_refused_at_every_nonce_raises(fs_scaled,
                                                        monkeypatch):
    prover, inputs = fs_scaled
    calls = []
    monkeypatch.setattr(PS, "_stage_grand_product", _refuse(
        PS._stage_grand_product, [False, False, True], calls,
        first_only=False))
    with pytest.raises(RuntimeError, match="in 32 retries"):
        prover.prove_many(*inputs)
    assert len(calls) == FSP.MAX_NONCE + 1 == 33


# ---- BN254 ----

@pytest.fixture(scope="module")
def bn_ctx():
    return PB.bn254_setup(NB, secret=SECRET_BN, device="cpu")


@pytest.fixture(scope="module")
def bn_batch(bn_ctx):
    sel, cp, a, b, c, chs, rnds = bn254_inputs()
    prover = PB.make_prover_bn254(bn_ctx, sel, cp)
    return prover, (a, b, c, chs, rnds), prover(a, b, c, chs, rnds)


def test_bn254_batch_matches_jax_and_single_proofs(bn_batch):
    prover, (a, b, c, chs, rnds), (proof, diags) = bn_batch
    got = bn254_lanes(proof, diags)
    assert got == GOLDEN["bn254"]
    assert all(all(lane["diags"]) for lane in got)
    # lane 0 is tests/test_torch_bn254.py's recorded single proof
    assert {k: tuple(int(v, 16) for v in got[0][k][:2])
            for k in JAX_POINTS} == JAX_POINTS
    assert {k: int(got[0][k], 16) for k in JAX_SCALARS} == JAX_SCALARS
    # lane 1's single proof (lane 0's is the recorded one above, which
    # tests/test_torch_bn254.py holds the port's single proof against)
    one, d = prover(a[1], b[1], c[1], chs[1], rnds[1])
    assert bn254_lanes(PB.stack_proofs([one, one]),
                       [torch.stack([f, f]) for f in d])[0] == got[1]


def test_bn254_poseidon_refusal_in_one_lane(bn_ctx, monkeypatch):
    """With the stand-in sponge of tests/test_torch_bn254_fs.py (the
    control flow is what is tested): lane 0 refused at nonce 0 takes
    nonce 1 (its challenges are the host replay's at nonce 1) and equals
    prove() of its inputs refused once, lane 1 keeps nonce 0; a lane
    refused at every nonce raises after 33 attempts."""
    t = 3
    monkeypatch.setattr(PO, "big_permute", lambda F, pp, s: F.add(
        s.roll(1, dims=-2), F.const(7)))
    monkeypatch.setattr(PO.PoseidonHost, "permute", lambda self, s: [
        (s[i - 1] + 7) % BN254_FR.p for i in range(t)])
    sel, cp, a, b, c, _, rnds = bn254_inputs()
    fs = FSP.BN254PoseidonFsProver(bn_ctx, sel, cp)
    real = PB._stage_grand_product
    calls = []
    monkeypatch.setattr(PB, "_stage_grand_product",
                        _refuse(real, [True, False], calls))
    outs = fs.prove_many(a, b, c, rnds)
    assert [o.nonce for o, _ in outs] == [1, 0] and len(calls) == 2
    assert all(bool(d.all_ok()) for _, d in outs)
    np.testing.assert_array_equal(FSP.derive_bn254_challenges_host(
        bn_ctx, list(fs.vk), outs[0][0].proof, 1), outs[0][0].challenge)
    calls.clear()
    monkeypatch.setattr(PB, "_stage_grand_product",
                        _refuse(real, True, calls))
    one, _ = fs.prove(a[0], b[0], c[0], rnds[0])
    assert bn254_fs_fields(one) == bn254_fs_fields(outs[0][0])
    # lane 1 refused at every nonce (a stand-in stage: only the flags
    # matter here)
    calls.clear()
    z_x = torch.zeros((BB, NB + 3, 16), dtype=torch.int64)
    monkeypatch.setattr(PB, "_stage_grand_product", lambda *args: (
        calls.append(1) or (z_x, torch.tensor([True, False]))))
    with pytest.raises(RuntimeError, match="in 32 retries"):
        fs.prove_many(a, b, c, rnds)
    assert len(calls) == FSP.MAX_NONCE + 1


# ---- recomputing the JAX values (heavy) ----

def _print_golden(name: str, value) -> None:
    print(json.dumps({name: value}, indent=1))


@heavy
def test_recompute_jax_scaled(scaled):
    name = "scaled_pi" if scaled["pi"] else "scaled"
    got = scaled_lanes(*jax_scaled(scaled["pi"]))
    _print_golden(name, got)
    assert got == GOLDEN[name]
    assert got == scaled_lanes(scaled["proof"], scaled["diags"])


@heavy
def test_recompute_jax_fs_poseidon():
    got = jax_fs_poseidon()
    _print_golden("scaled_fs_poseidon", got)
    assert got == GOLDEN["scaled_fs_poseidon"]


@heavy
def test_recompute_jax_fs_poseidon_pi():
    got = jax_fs_poseidon(pi=True)
    _print_golden("scaled_fs_poseidon_pi", got)
    assert got == GOLDEN["scaled_fs_poseidon_pi"]


@heavy
def test_recompute_jax_bn254(bn_batch):
    got = bn254_lanes(*jax_bn254())
    _print_golden("bn254", got)
    assert got == GOLDEN["bn254"]
    assert got == bn254_lanes(*bn_batch[2])
