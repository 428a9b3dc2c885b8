"""The port's Poseidon (plonk_tpu_torch.ops.poseidon) against the JAX
package's (plonk_tpu.ops.poseidon): parameters, the permutation on seeded
batched states (JAX's permute and the Python-int oracle), the
sponge and its rejection loop, and the tree digest. Exact equality."""
import numpy as np
import pytest
import torch

from plonk_tpu.ops import poseidon as JPO
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.utils.params import SCALED_FR as J_SCALED_FR
from plonk_tpu_torch.ops import poseidon as PO
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.utils.params import SCALED_FR

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
