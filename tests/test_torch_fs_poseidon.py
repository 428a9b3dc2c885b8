"""The port's Poseidon Fiat–Shamir prover (plonk_tpu_torch.models.
fs_poseidon) against the JAX package's, on the CPU.

- the proof at n = 8 (the fixture of tests/test_fs_poseidon.py: secret
  987654321, square_chain_circuit(r, 8, x0=7), rand9 12 23 .. 91) equals
  JAX's word for word, nonce and challenge included, and equals
  prove_scaled given its challenges;
- the host replay (`derive_challenges_host`) of both packages derives the
  device sponge's challenges from the proof;
- it verifies; a tampered evaluation, commitment or nonce is rejected; the
  public inputs are bound; `prove_many` equals the single proofs; the
  retry loop makes JAX's 33 attempts.

JAX's Poseidon FS prover takes ~4 minutes of XLA compile on the CPU, so
its proof was recorded once; it is what

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_fs_poseidon.py -k recompute

recomputes and compares."""
import os

import numpy as np
import pytest
import torch

from plonk_tpu.models import fs_poseidon as JFSP
from plonk_tpu_torch.models import fs_poseidon as FSP
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.synthetic import square_chain_circuit
from plonk_tpu_torch.utils import convert
from test_torch_fiat_shamir import fs_fields, np_points

torch.set_num_threads(1)

N = 8
SECRET = 987654321
RND = np.array([12, 23, 34, 45, 56, 67, 78, 89, 91])
# JAX's PoseidonFsProver proof for that fixture (points as x, y words and
# inf, evaluations in standard form)
JAX_FS = dict(
    nonce=0, challenge=[110626464, 89334114, 53594106, 84604873, 28979166],
    a_s=(680937270, 150710657, False), b_s=(119233235, 1103647440, False),
    c_s=(704190803, 591683873, False), z_s=(513911506, 992827169, False),
    t_lo_s=(590540831, 1810528715, False),
    t_mid_s=(1156991109, 893428467, False),
    t_hi_s=(515995949, 628260892, False),
    w_z_s=(927425132, 1556379772, False),
    w_z_omega_s=(1287019649, 1273918362, False),
    a_z=11177442, b_z=40948743, c_z=95631961, s_sigma_1_z=26003066,
    s_sigma_2_z=4896848, r_z=36655834, z_omega_z=46206037)


@pytest.fixture(scope="module")
def setup():
    ctx = PS.scaled_new(N, secret=SECRET, device="cpu")
    circuit = square_chain_circuit(ctx.params.field.p, N, x0=7)
    prover = FSP.PoseidonFsProver(ctx, *circuit[:2])
    out, diags = prover.prove(*circuit[2:], RND)
    return ctx, prover, circuit, out, diags


def test_proof_matches_recorded_jax(setup):
    ctx, _, _, out, diags = setup
    assert bool(diags.all_ok())
    assert fs_fields(out) == JAX_FS
    alpha, beta, gamma, z, v = (int(x) for x in out.challenge)
    assert 0 not in (alpha, beta, gamma, z, v)
    assert pow(z, N, ctx.params.field.p) != 1


def test_host_replay_matches_jax(setup):
    """derive_challenges_host of both packages (JAX's on numpy copies of
    the proof and key), with the host digest and with the device one."""
    ctx, prover, _, out, _ = setup
    want = JFSP.derive_challenges_host(
        ctx, np_points(prover.vk), convert.proof_to_numpy(out.proof),
        out.nonce)
    got = FSP.derive_challenges_host(ctx, list(prover.vk), out.proof,
                                     out.nonce)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == JAX_FS["challenge"]
    pid = int(ctx.Fr.decode(prover._zero_pi_digest))
    np.testing.assert_array_equal(FSP.derive_challenges_host(
        ctx, list(prover.vk), out.proof, out.nonce, pi_digest=pid), want)
    back = convert.poseidon_fs_proof_from_numpy(
        convert.fs_proof_to_numpy(out), "cpu")
    assert type(back) is FSP.PoseidonFsProof and fs_fields(back) == JAX_FS


def test_matches_interactive_prover(setup):
    ctx, _, circuit, out, _ = setup
    proof, diags = PS.prove_scaled(ctx, *circuit, out.challenge, RND)
    assert bool(diags.all_ok())
    assert fs_fields(FSP.PoseidonFsProof(proof, out.nonce,
                                         out.challenge)) == fs_fields(out)


def test_verify_accepts(setup):
    ctx, prover, _, out, _ = setup
    assert FSP.verify_scaled_fs_poseidon(ctx, prover.vk, out)


@pytest.mark.parametrize("tamper", ["evaluation", "commitment", "nonce"])
def test_verify_rejects_tampered(setup, tamper):
    ctx, prover, _, out, _ = setup
    p, nonce = out.proof, out.nonce
    if tamper == "evaluation":
        p = p._replace(a_z=(p.a_z + 1) % ctx.params.field.p)
    elif tamper == "commitment":
        p = p._replace(t_hi_s=p.t_hi_s._replace(y=p.t_hi_s.y + 1))
    else:
        nonce += 1
    assert not FSP.verify_scaled_fs_poseidon(
        ctx, prover.vk, FSP.PoseidonFsProof(p, nonce, out.challenge))


def test_public_inputs_bound(setup):
    """Gate 0 rebound to a[0] + PI[0] = 0: the proof for PI verifies under
    PI and not under PI with one input changed, whose digest (device and
    host alike) changes every challenge."""
    ctx, _, circuit, _, _ = setup
    sel, cp, a, b, c = circuit
    r = ctx.params.field.p
    sel = np.array(sel)
    sel[:, 0] = 0
    sel[0, 0] = 1
    pi = np.zeros(N, dtype=np.uint32)
    pi[0] = (r - int(a[0])) % r
    prover = FSP.PoseidonFsProver(ctx, sel, cp)
    out, diags = prover.prove(a, b, c, RND, public_inputs=pi)
    assert bool(diags.all_ok())
    assert FSP.verify_scaled_fs_poseidon(ctx, prover.vk, out,
                                         public_inputs=pi)
    pi2 = pi.copy()
    pi2[0] = (int(pi2[0]) + 1) % r
    ch2 = FSP.derive_challenges_host(ctx, list(prover.vk), out.proof,
                                     out.nonce, public_inputs=pi2)
    assert (ch2 != out.challenge).all()
    assert not FSP.verify_scaled_fs_poseidon(ctx, prover.vk, out,
                                             public_inputs=pi2)


def test_prove_many_matches_single(setup):
    ctx, prover, circuit, _, _ = setup
    B = 3
    wits = [square_chain_circuit(ctx.params.field.p, N, x0=7 + i)[2:]
            for i in range(B)]
    a, b, c = (np.stack([w[k] for w in wits]) for k in range(3))
    rnds = np.stack([RND + i for i in range(B)])
    outs = prover.prove_many(a, b, c, rnds)
    assert len(outs) == B
    for i, (out, diags) in enumerate(outs):
        single, sd = prover.prove(a[i], b[i], c[i], rnds[i])
        assert bool(diags.all_ok()) and bool(sd.all_ok())
        assert fs_fields(out) == fs_fields(single)
    assert fs_fields(outs[0][0]) == JAX_FS


def test_retry_makes_33_attempts(setup, monkeypatch):
    """Nonces 0..MAX_NONCE: a refused denominator at nonce 0 gives nonce
    1 (the host replay derives its challenges); all refused raises after
    MAX_NONCE + 1 = 33 attempts, as JAX's while loop."""
    ctx, prover, circuit, _, _ = setup
    real = PS._stage_grand_product
    calls = []

    def refuse(limit):
        def stage(*args):
            z_x, ok = real(*args)
            calls.append(1)
            return z_x, ok & torch.tensor(len(calls) > limit)
        return stage

    monkeypatch.setattr(PS, "_stage_grand_product", refuse(1))
    out, diags = prover.prove(*circuit[2:], RND)
    assert out.nonce == 1 and bool(diags.all_ok())
    np.testing.assert_array_equal(FSP.derive_challenges_host(
        ctx, list(prover.vk), out.proof, 1), out.challenge)
    calls.clear()
    monkeypatch.setattr(PS, "_stage_grand_product", refuse(10 ** 6))
    with pytest.raises(RuntimeError, match="in 32 retries"):
        prover.prove(*circuit[2:], RND)
    assert len(calls) == FSP.MAX_NONCE + 1 == 33


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="JAX's Poseidon FS prover takes minutes of "
                           "XLA:CPU; set PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values(setup):
    """JAX's proof, carried across with its nonce and challenge, equals the
    recorded values and the port's proof."""
    from plonk_tpu.models import plonk_scaled as JPS
    from plonk_tpu.models.synthetic import square_chain_circuit as j_chain
    jctx = JPS.scaled_new(N, secret=SECRET)
    sel, cp, a, b, c = j_chain(jctx.params.field.p, N, x0=7)
    jout, jdiags = JFSP.PoseidonFsProver(jctx, sel, cp).prove(
        a, b, c, RND.astype(np.uint32))
    assert bool(jdiags.all_ok())
    got = fs_fields(convert.poseidon_fs_proof_from_numpy(jout, "cpu"))
    print(got)
    assert got == JAX_FS == fs_fields(setup[3])
