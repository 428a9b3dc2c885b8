"""The port's Poseidon (plonk_tpu_torch.ops.poseidon) against the JAX
package's (plonk_tpu.ops.poseidon): parameters, the permutation on seeded
batched states (JAX's permute and the Python-int oracle), the
sponge and its rejection loop, and the tree digest; then the same for the
16-limb BN254-Fr half (big_permute, big_absorb_elements, big_squeeze,
big_tree_digest at t = 3, capacity 1). Exact equality."""
import numpy as np
import pytest
import torch

from plonk_tpu.ops import poseidon as JPO
from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import BN254_FR as J_BN254_FR
from plonk_tpu.utils.params import SCALED_FR as J_SCALED_FR
from plonk_tpu_torch.ops import poseidon as PO
from plonk_tpu_torch.ops.bigfield import BigMontField
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.utils.params import BN254_FR, SCALED_FR

R = SCALED_FR.p
Fr = MontField(SCALED_FR)
POS = PO.make_params(R)
BABYBEAR = 15 * 2 ** 27 + 1


def _states(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, R, size=shape + (8,))


@pytest.mark.parametrize("p,t", [(R, 8), (R, 3), (BABYBEAR, 8)])
def test_params_match_jax(p, t):
    got, want = PO.make_params(p, t), JPO.make_params(p, t)
    assert (got.alpha, got.full_rounds, got.partial_rounds) == \
        (want.alpha, want.full_rounds, want.partial_rounds)
    assert got.arc == want.arc and got.mds == want.mds
    if (p, t) == (R, 8):
        assert (got.alpha, got.rounds) == (5, 30)


def test_permute_matches_jax_and_host():
    """(3, 4) seeded states: the port's permute equals JAX's permute and
    the Python-int oracle of both packages, lane by lane."""
    import jax.numpy as jnp
    std = _states(7, (3, 4))
    got = Fr.decode(PO.permute(Fr, POS, Fr.array(std, "cpu"))).numpy()
    JF = JMontField(J_SCALED_FR)
    want = np.asarray(JF.decode(JPO.permute(
        JF, JPO.make_params(R), JF.encode(jnp.asarray(std, jnp.uint32)))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    host, jhost = PO.PoseidonHost(POS), JPO.PoseidonHost(JPO.make_params(R))
    for lane in std.reshape(-1, 8)[:4]:
        assert host.permute(lane.tolist()) == jhost.permute(lane.tolist())
    for i in range(3):
        for j in range(4):
            assert got[i, j].tolist() == host.permute(std[i, j].tolist())


def test_sponge_matches_host_sponge():
    """absorb_elements (ints and tensors, several rate-blocks) and three
    squeezes equal JAX's HostSponge on 5 lanes of different elements."""
    rng = np.random.default_rng(11)
    elems = rng.integers(0, R, size=(9, 5))
    state = Fr.zeros((5, 8), "cpu")
    dev_elems = [17] + [Fr.array(e, "cpu") for e in elems]
    state = PO.absorb_elements(Fr, POS, state, dev_elems)
    outs = []
    for _ in range(3):
        v, state = PO.squeeze(Fr, POS, state)
        outs.append(v.numpy())
    for lane in range(5):
        hs = JPO.HostSponge(JPO.make_params(R))
        hs.absorb_elements([17] + elems[:, lane].tolist())
        want = [hs.squeeze() for _ in range(3)]
        assert [int(o[lane]) for o in outs] == want
        np.testing.assert_array_equal(Fr.decode(state[lane]).numpy(),
                                      hs.state)


def test_squeeze_rejection_is_masked_per_lane():
    """With pow_n_not_one = 2^22 (H the 2^22-torsion, 1 in 27 candidates
    rejected) the lanes that reject permute again while the others keep
    their state; every lane equals HostSponge's squeeze."""
    n = 1 << 22
    std = _states(3, (256,))
    host = JPO.PoseidonHost(JPO.make_params(R))
    first = [host.permute(s.tolist())[0] for s in std]
    rejected = [pow(v, n, R) == 1 for v in first]
    assert 0 < sum(rejected) < len(std)
    v, state = PO.squeeze(Fr, POS, Fr.array(std, "cpu"), pow_n_not_one=n)
    for lane in range(len(std)):
        hs = JPO.HostSponge(JPO.make_params(R))
        hs.state = std[lane].tolist()
        assert int(v[lane]) == hs.squeeze(pow_n_not_one=n), lane
        assert Fr.decode(state[lane]).tolist() == hs.state
        assert (int(v[lane]) != first[lane]) == rejected[lane]
    z = int(v[rejected.index(True)])
    assert z != 0 and pow(z, n, R) != 1


@pytest.mark.parametrize("m", [1, 2, 64])
def test_tree_digest_matches_host(m):
    leaves = np.random.default_rng(m).integers(0, R, size=m)
    got = PO.tree_digest(Fr, POS, torch.as_tensor(leaves))
    want = JPO.host_tree_digest(JPO.make_params(R), leaves.tolist())
    assert int(Fr.decode(got)) == want == PO.host_tree_digest(POS, leaves)


# ---- the 16-limb half (BN254-Fr, the BN254 transcript's t = 3) ----

BR = BN254_FR.p
BF = BigMontField(BN254_FR)
BPOS = PO.make_params(BR, t=3)


def _jax_big():
    return JBigMontField(J_BN254_FR, rolled=True), JPO.make_params(BR, t=3)


def _big_ints(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % BR
            for _ in range(int(np.prod(shape)))]
    return np.array(vals, dtype=object).reshape(shape)


def _host_unpermute(pp, state) -> list:
    """The inverse permutation on the host: a state whose permutation has
    the given lanes (so a squeeze's first candidate can be chosen)."""
    p, t = pp.p, pp.t
    m = [list(row) for row in pp.mds]
    inv = [[int(i == j) for j in range(t)] for i in range(t)]
    for c in range(t):                    # Gauss-Jordan inverse mod p
        piv = next(r for r in range(c, t) if m[r][c])
        m[c], m[piv], inv[c], inv[piv] = m[piv], m[c], inv[piv], inv[c]
        k = pow(m[c][c], -1, p)
        m[c] = [x * k % p for x in m[c]]
        inv[c] = [x * k % p for x in inv[c]]
        for r in range(t):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(x - f * y) % p for x, y in zip(m[r], m[c])]
                inv[r] = [(x - f * y) % p for x, y in zip(inv[r], inv[c])]
    root = pow(pp.alpha, -1, p - 1)
    s = list(state)
    for r in reversed(range(pp.rounds)):
        s = [sum(inv[i][j] * s[j] for j in range(t)) % p for i in range(t)]
        lanes = range(t) if pp.is_full_round(r) else (0,)
        for i in lanes:
            s[i] = pow(s[i], root, p)
        s = [(x - c) % p for x, c in zip(s, pp.arc[r])]
    return s


def test_big_params_match_jax():
    want = JPO.make_params(BR, t=3)
    assert (BPOS.alpha, BPOS.full_rounds, BPOS.partial_rounds) == (5, 8, 118)
    assert BPOS.arc == want.arc and BPOS.mds == want.mds


def test_big_permute_matches_jax_and_host():
    """A (2, 3) batch of seeded states: the port's big_permute equals
    JAX's big_permute and the Python-int oracle, lane by lane."""
    std = _big_ints(5, (2, 3))
    got = BF.decode_host(PO.big_permute(BF, BPOS, BF.array(std, "cpu")))
    JF, jpp = _jax_big()
    want = JF.decode_host(np.asarray(JPO.big_permute(JF, jpp,
                                                     JF.array(std))))
    assert got.tolist() == want.tolist()
    host = PO.PoseidonHost(BPOS)
    for i in range(2):
        assert got[i].tolist() == host.permute(list(std[i]))
    assert _host_unpermute(BPOS, host.permute(list(std[0]))) == list(std[0])


def test_big_sponge_matches_jax_and_host():
    """big_absorb_elements (ints and tensors, three rate-blocks) on a
    batch of three lanes, then two squeezes, the second with
    pow_n_not_one = 8: lane 0 restarts from a state whose first candidate
    is 0 and lane 1 from one whose second candidate is an 8th root of
    unity (both rejected, so those lanes permute again while the others
    keep their state). Every lane equals HostSponge; lane 2 also JAX's
    big_absorb_elements and big_squeeze."""
    elems = _big_ints(6, (4, 3))
    rest = _big_ints(7, (2, 2))
    host = PO.PoseidonHost(BPOS)
    state = PO.big_absorb_elements(BF, BPOS, BF.zeros((3, 3), "cpu"),
                                   [17] + [BF.array(e, "cpu")
                                           for e in elems])
    mid = BF.decode_host(state).tolist()
    for lane in range(3):
        hs = PO.HostSponge(BPOS, capacity=1)
        hs.absorb_elements([17] + elems[:, lane].tolist())
        assert mid[lane] == hs.state
    w8 = BN254_FR.root_of_unity(8)
    starts = [_host_unpermute(BPOS, [0] + list(rest[0])),
              _host_unpermute(BPOS, _host_unpermute(
                  BPOS, [w8] + list(rest[1]))),
              mid[2]]
    assert host.permute(starts[0])[0] == 0
    assert pow(host.permute(host.permute(starts[1]))[0], 8, BR) == 1
    state = BF.array(np.array(starts, dtype=object), "cpu")
    v1, state = PO.big_squeeze(BF, BPOS, state)
    v2, state = PO.big_squeeze(BF, BPOS, state, pow_n_not_one=8)
    got = [[from_w(v[lane]) for v in (v1, v2)] for lane in range(3)]
    for lane in range(3):
        hs = PO.HostSponge(BPOS, capacity=1)
        hs.state = list(starts[lane])
        assert got[lane] == [hs.squeeze(), hs.squeeze(pow_n_not_one=8)]
        assert BF.decode_host(state[lane]).tolist() == hs.state
    JF, jpp = _jax_big()
    js = JPO.big_absorb_elements(
        JF, jpp, JF.zeros((3,)), [17] + [JF.array(e[2]) for e in elems])
    assert JF.decode_host(np.asarray(js)).tolist() == mid[2]
    jv1, js = JPO.big_squeeze(JF, jpp, js)
    jv2, js = JPO.big_squeeze(JF, jpp, js, pow_n_not_one=8)
    assert [from_w(jv1), from_w(jv2)] == got[2]


def from_w(w) -> int:
    """Standard-form 16-bit words -> int."""
    v = 0
    for x in reversed([int(y) for y in np.asarray(w).reshape(-1)]):
        v = (v << 16) | x
    return v


def test_big_tree_digest_matches_jax_and_host():
    """Eight random leaves: the port's big_tree_digest, JAX's
    big_tree_digest, and both packages' host_tree_digest."""
    leaves = _big_ints(8, (8,))
    words = np.stack([[(int(v) >> (16 * k)) & 0xFFFF for k in range(16)]
                      for v in leaves])
    got = from_w(BF.decode(PO.big_tree_digest(BF, BPOS,
                                              torch.as_tensor(words))))
    JF, jpp = _jax_big()
    jd = JPO.big_tree_digest(JF, jpp, np.asarray(words, np.uint32))
    want = JPO.host_tree_digest(jpp, leaves.tolist())
    assert got == int(JF.decode_host(np.asarray(jd)[None])[0]) == want
    assert PO.host_tree_digest(BPOS, leaves.tolist()) == want


@pytest.mark.parametrize("m", [8, 64])
def test_host_tree_digest_of_repeated_leaves(m):
    """host_tree_digest permutes a repeated pair once a level; the digest
    of zeros, and of a pattern that repeats, equals JAX's."""
    jpp = JPO.make_params(BR, t=3)
    pattern = _big_ints(9, (2,)).tolist()
    for leaves in ([0] * m, pattern * (m // 2)):
        assert (PO.host_tree_digest(BPOS, leaves)
                == JPO.host_tree_digest(jpp, leaves))
