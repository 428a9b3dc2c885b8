"""The BN254 slice of the port on the CPU at n = 8 gates:
bn254_setup -> make_prover_bn254 -> make_vk_bn254 -> verify_bn254.

- the SRS equals tau^i G and tau H from the python-int oracle;
- the prover's diagnostics hold;
- the wire commitments equal the oracle's KZG evaluation at the known tau
  (the check of tests/test_plonk_bn254.py), and every verifying-key
  commitment equals its closed form (q_m = 1, q_o = -1, s1 = X, ...);
- verify accepts the proof and rejects it with r_z tampered;
- the proof equals, word for word, the JAX package's proof for the same
  inputs (tolerance zero). Those values were recorded once, because the
  JAX BN254 prover takes ~15 minutes of XLA:CPU compile: they are what

      PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \
          tests/test_torch_bn254.py -k recompute

  prints (jax.jit(PB.prove_bn254) at n = 8, secret 987654321, the
  circuit of synthetic.bn254_mul_circuit(8) -- numpy seed 11, the circuit
  of tests/test_bn254_smoke.py -- challenges [111111 .. 555555] and
  rand9 = 17..25); that test, skipped without the JAX package's heavy-test
  flag, recomputes and compares them.
"""
import os

import numpy as np
import pytest
import torch

import bn254_oracle as O
from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.synthetic import (bn254_mul_circuit, from_words,
                                              words_vec)
from plonk_tpu_torch.utils import convert
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

N = 8
SECRET = 987654321
R = O.R
CH = words_vec([111111, 222222, 333333, 444444, 555555])
RND = words_vec(range(17, 26))

# the JAX package's proof for these inputs, standard form (see above)
JAX_SCALARS = dict(
    a_z=0x136003277444e0948f970a92a66812d0a653c316b2b8b5fc05f8fa4328ba0289,
    b_z=0x1b90e96c0d1aed1ebb9401e9d0d91fc43416b4e40cba3012ccc3cfbc617851d4,
    c_z=0x13a8a59e751171a331cf4a3bd126bf06449b65855fbb59dc964221a38516604e,
    s_sigma_1_z=0x6c81c,
    s_sigma_2_z=0x21e88c,
    r_z=0x15eb105fb82cb8907f56cfccde29852d8d5e8d90c24295af5ecf17bd02a8caef,
    z_omega_z=0x1bbbb4a369d870ef5ae850ccac4d4e7b7ca474bb06bf5ba87d9b3b7e0250010a,
)
JAX_POINTS = dict(
    a_s=(0x226a857a70c5237092efbb553637324b4d00ad4d86167f5d0d163b630fcda920,
         0x1f648a2d972f4f588724ed3d009338aab0abdabb0d895e58871c240e03c5a653),
    b_s=(0x4b1efd3d8582cf9d5f02b164bee1b75a48d028e803814329fffac463009b054,
         0x235f88f1d01abdb52340880f82727a2d400d5c64d7128843961bca0b52bb3468),
    c_s=(0x17bea2871b4359a5a205a0ed8122f97aef1bc368e18053be33b5b1b86c031cf0,
         0xac5234471f73121303c5ff2165c1b4f454c61f515bcb9a629c36ffd90605ec3),
    z_s=(0x29218235ffb2944fb4958b1e56dbbe2b55ba3fc4a84067d397e96fd9137e8815,
         0x24eb9a03953c53533eabb190ec51df08af933080b64d5d089e3b2fe8e51d9e2a),
    t_lo_s=(0x852cc7272edc02ef83d729c9cc0a6648831b1cc2a602896182c9bdfc2c53d9a,
         0xc867bebddb5aa6a264b8bba11ca958112beaefec8bf42d69b836084d28e9424),
    t_mid_s=(0x1ec389b7a24aece915fd13a7e32f143473c9aa62a38046ae84acbf18f1f34fb0,
         0x26365c46b4c1f91b6d648e9429c1ab2103db3b60f3ed9065034493e519ea2c5f),
    t_hi_s=(0x142ba9de957c97d98a81819dfa4b1c55d53f8a6b17130564246c272a821402a2,
         0x1ef73078aa68c8d16d998a6c93dfd85d588cf368728bbc4630d11d296610b951),
    w_z_s=(0x1fd1cf36523fc492289d490f80cb3849f8ea9d280d66765b9dd82d971a9a6992,
         0x242b8f177914140ca942eb13f2294128ab31a23bc735af3ee4d986f41c3533dc),
    w_z_omega_s=(0xc012db6d0618ba653b09afef7e01817b629df224ef38c12a8762e4bbaa85a4,
         0x211e9e5294d3b07a31257f566ddafbe05d9bdca44afd66be3d3a7910eceb924e),
)


@pytest.fixture(scope="module")
def slice_run():
    ctx = PB.bn254_setup(N, secret=SECRET, device="cpu")
    circuit = bn254_mul_circuit(N)
    sel, cp, a, b, c = circuit
    proof, diags = PB.make_prover_bn254(ctx, sel, cp)(a, b, c, CH, RND)
    vk = PB.make_vk_bn254(ctx, sel, cp)
    return ctx, circuit, proof, diags, vk


def _point(p):
    return None if bool(p.inf) else (from_words(p.x), from_words(p.y))


def test_srs_matches_oracle(slice_run):
    ctx = slice_run[0]
    Fq = ctx.Fq
    g = ctx.srs.g1s
    tau = SECRET % R
    assert ctx.srs.length == N + 5
    xs, ys = Fq.decode_host(g.x), Fq.decode_host(g.y)
    for i in range(ctx.srs.length):
        want = O.g1_mul(O.G1_GEN, pow(tau, i, R))
        assert (int(xs[i]), int(ys[i])) == want, i
    assert not bool(g.inf.any())
    dec2 = lambda c: tuple(int(v) for v in Fq.decode_host(c))
    h = (O.G2_GEN_X, O.G2_GEN_Y)
    assert (dec2(ctx.srs.g2_1x), dec2(ctx.srs.g2_1y)) == h
    assert (dec2(ctx.srs.g2_sx), dec2(ctx.srs.g2_sy)) == O.g2_mul(h, tau)


def test_diagnostics(slice_run):
    diags = slice_run[3]
    assert bool(diags.all_ok())
    assert all(bool(d) for d in diags)


@pytest.mark.parametrize("wire", [0, 1, 2])
def test_wire_commitments_match_kzg_oracle(slice_run, wire):
    """[f(tau)] G with f = (b1 X + b2) z_H + sum_i w_i L_i(X), b1, b2 the
    wire's blinding scalars (rand9[2*wire], rand9[2*wire + 1])."""
    ctx, circuit, proof, _, _ = slice_run
    vals = [from_words(w) for w in circuit[2 + wire]]
    tau = SECRET % R
    omega = ctx.omega
    zh_tau = (pow(tau, N, R) - 1) % R
    n_inv = pow(N, -1, R)
    acc = 0
    for i, v in enumerate(vals):
        wi = pow(omega, i, R)
        li = zh_tau * n_inv % R * wi % R * pow((tau - wi) % R, R - 2, R) % R
        acc = (acc + v * li) % R
    b1, b2 = 17 + 2 * wire, 18 + 2 * wire
    f_tau = ((b1 * tau + b2) % R * zh_tau + acc) % R
    got = _point(getattr(proof, ("a_s", "b_s", "c_s")[wire]))
    assert got == O.g1_mul(O.G1_GEN, f_tau)


@pytest.mark.parametrize("name,scalar", [
    ("q_m_s", 1), ("q_l_s", 0), ("q_r_s", 0), ("q_o_s", R - 1),
    ("q_c_s", 0), ("s1_s", "tau"), ("s2_s", "5tau"), ("s3_s", "25tau")])
def test_vk_commitments_closed_form(slice_run, name, scalar):
    """Constant selectors commit to multiples of G; the identity
    permutation's sigmas are X, k1 X and k2 X."""
    tau = SECRET % R
    k = {"tau": tau, "5tau": 5 * tau % R, "25tau": 25 * tau % R}.get(
        scalar, scalar)
    got = _point(getattr(slice_run[4], name))
    assert got == O.g1_mul(O.G1_GEN, k)


@pytest.mark.parametrize("name", PB.SCALAR_FIELDS)
def test_scalars_match_recorded_jax(slice_run, name):
    assert from_words(getattr(slice_run[2], name)) == JAX_SCALARS[name]


@pytest.mark.parametrize("name", PB.POINT_FIELDS)
def test_points_match_recorded_jax(slice_run, name):
    assert _point(getattr(slice_run[2], name)) == JAX_POINTS[name]


def test_verify_accepts(slice_run):
    ctx, _, proof, _, vk = slice_run
    assert PB.verify_bn254(ctx, vk, proof, CH)


def test_verify_rejects_tampered_r_z(slice_run):
    ctx, _, proof, _, vk = slice_run
    bad = proof._replace(r_z=torch.as_tensor(words_vec(
        [(from_words(proof.r_z) + 1) % R])[0].astype(np.int64)))
    assert not PB.verify_bn254(ctx, vk, bad, CH)


def test_proof_round_trips_through_numpy(slice_run):
    proof = slice_run[2]
    back = convert.bn254_proof_from_numpy(convert.bn254_proof_to_numpy(
        proof), "cpu")
    for a, b in zip(proof, back):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


def test_srs_and_table_carried_across(slice_run):
    """An SRS in the JAX package's npz layout and a window table as x/y/inf
    arrays carried into the port give the port's own words."""
    ctx = slice_run[0]
    s = ctx.srs
    np_ = lambda t: t.numpy().astype(np.uint32)
    srs = convert.bn254_srs_from_numpy(
        np_(s.g1s.x), np_(s.g1s.y), s.g1s.inf.numpy(), np_(s.g2_1x),
        np_(s.g2_1y), np_(s.g2_sx), np_(s.g2_sy), s.length, "cpu")
    for a, b in zip(tuple(srs.g1s) + tuple(srs[1:5]),
                    tuple(s.g1s) + tuple(s[1:5])):
        assert torch.equal(a, b)
    tbl = PB.bn254_fixed_base_table(ctx)
    back = convert.big_table_from_numpy(np_(tbl.x), np_(tbl.y),
                                        tbl.inf.numpy(), 4, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[:3], tbl[:3]))


def test_entry_points_default_to_the_card():
    """Without CUDA the default device raises; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.scaled_new(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.bn254_setup(8)
    assert PS.scaled_new(16, device="cpu").device.type == "cpu"


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="compiles the JAX BN254 prover (~15 minutes of "
                           "XLA:CPU); set PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values():
    import jax
    from plonk_tpu.models import plonk_bn254 as JPB
    sel, cp, a, b, c = bn254_mul_circuit(N)
    ctx = JPB.bn254_setup(N, secret=SECRET, rolled=True)
    proof, diags = jax.jit(lambda c_, r_: JPB.prove_bn254(
        ctx, sel, cp, a, b, c, c_, r_))(CH, RND)
    assert bool(diags.all_ok())
    for name in PB.SCALAR_FIELDS:
        v = from_words(np.asarray(getattr(proof, name)))
        print(f"    {name}={hex(v)},")
        assert v == JAX_SCALARS[name]
    for name in PB.POINT_FIELDS:
        p = getattr(proof, name)
        xy = (from_words(np.asarray(p.x)), from_words(np.asarray(p.y)))
        print(f"    {name}=({hex(xy[0])},\n         {hex(xy[1])}),")
        assert xy == JAX_POINTS[name]
