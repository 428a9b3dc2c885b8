"""PLONK verifier for the toy prover: port of `plonk_tpu/models/verifier.py`
(the reference has none; its test discards the proof, src/plonk-test.c:270).

It checks proofs of the "standard" linearization dialect over a fixed
(non-degenerate) SRS, with the pairing of ops/pairing.py over the toy
curve (r = 17, final exponent (101^2 - 1)/17 = 600 through the Frobenius
split).

Protocol identity (from the prover's quotient t*z_H = t1 + t2 - t3 + t4,
PI = 0):

    t(z) * z_H(z) = r(z) - r_0,
    r_0 = alpha * (a_z + beta*s1_z + gamma)(b_z + beta*s2_z + gamma)
                * (c_z + gamma) * z_omega_z
        + alpha^2 * L1(z)

Two KZG openings (the reference proof has no multipoint-combination
challenge, so they stay separate):

    e(W_z,  [s]_2) == e(z * W_z  + [F] - [E], [1]_2)
    e(W_zw, [s]_2) == e(z*omega * W_zw + [z_x] - z_omega_z * G, [1]_2)

with [F] the v-powered combination of the proof commitments and the
linearization commitment [D] rebuilt from the verification key, and
[E] = (t_z + v r_z + v^2 a_z + ... + v^6 s2_z) * G.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import ntt as N
from ..ops.curve import (G1, G2, g1_add, g1_generator, g1_mul, g1_neg,
                         gt_equal)
from ..ops.pairing import pairing
from .constraints import Constraints
from .plonk import PlonkContext, Proof, _commit, _words, sigma_to_roots


@dataclasses.dataclass(frozen=True)
class VerificationKey:
    """Commitments to the circuit polynomials (made once per circuit) and
    the G2 side of the SRS."""
    q_m_s: G1
    q_l_s: G1
    q_r_s: G1
    q_o_s: G1
    q_c_s: G1
    s_sigma_1_s: G1
    s_sigma_2_s: G1
    s_sigma_3_s: G1
    g2_1: G2
    g2_s: G2
    n: int


def make_verification_key(ctx: PlonkContext, cons: Constraints
                          ) -> VerificationKey:
    """Commit the 5 selector and 3 permutation polynomials (the verifier
    half of the preprocessing that the reference's plonk_new never does),
    as one batch of 8 commitments."""
    sel = cons.selectors_device(ctx.device)
    sigmas = [sigma_to_roots(ctx, c) for c in (cons.c_a, cons.c_b, cons.c_c)]
    stacked = torch.stack([sel["q_m"], sel["q_l"], sel["q_r"], sel["q_o"],
                           sel["q_c"]] + sigmas)
    cms = _commit(ctx, N.interpolate(ctx.Fr, stacked, ctx.params.omega))
    pts = [G1(cms.x[i], cms.y[i], cms.inf[i]) for i in range(8)]
    return VerificationKey(
        q_m_s=pts[0], q_l_s=pts[1], q_r_s=pts[2], q_o_s=pts[3], q_c_s=pts[4],
        s_sigma_1_s=pts[5], s_sigma_2_s=pts[6], s_sigma_3_s=pts[7],
        g2_1=ctx.srs.g2_1, g2_s=ctx.srs.g2_s, n=ctx.h_len)


def _kzg_check(Fq, curve, w_cm: G1, point, combined: G1, eval_neg: G1,
               g2_1: G2, g2_s: G2, nbits: int) -> torch.Tensor:
    """e(W, [s]_2) == e(point * W + combined - [eval], [1]_2)."""
    rhs_pt = g1_add(Fq, g1_mul(Fq, w_cm, point, nbits),
                    g1_add(Fq, combined, eval_neg))
    return gt_equal(pairing(Fq, curve, w_cm, g2_s),
                    pairing(Fq, curve, rhs_pt, g2_1))


def verify(ctx: PlonkContext, vk: VerificationKey, proof: Proof,
           challenge) -> bool:
    """Verify a standard-dialect proof. The challenges must be the
    prover's (the reference's CHALLENGE struct; no transcript hash)."""
    ok1, ok2 = verify_flags(ctx, vk, proof, challenge)
    return bool(ok1) and bool(ok2)


def verify_flags(ctx: PlonkContext, vk: VerificationKey, proof: Proof,
                 challenge):
    """The two pairing-check booleans, as tensors."""
    Fr, Fq = ctx.Fr, ctx.Fq
    pp = ctx.params
    curve = pp.curve
    r = pp.field.p
    nb = r.bit_length()              # scalar ladders: Fr words are < r
    n = vk.n
    challenge = _words(challenge, ctx.device)
    alpha, beta, gamma, z, v = (challenge[..., i] for i in range(5))
    k1c, k2c = Fr.const(pp.k1), Fr.const(pp.k2)
    g = g1_generator(curve, Fq, ctx.device)

    def mul(pt, s):
        return g1_mul(Fq, pt, s, nb)

    # domain evaluations
    z_h_z = Fr.sub(Fr.pow_static(z, n), Fr.const(1))          # z^n - 1
    # L1(z) = (z^n - 1) / (n (z - 1))
    n_inv = Fr.const(pow(n, -1, r))
    l_1_z = Fr.mul(Fr.mul(z_h_z, n_inv), Fr.inv(Fr.sub(z, Fr.const(1))))

    a_z, b_z, c_z = proof.a_z, proof.b_z, proof.c_z
    s1_z, s2_z = proof.s_sigma_1_z, proof.s_sigma_2_z
    r_z, zw_z = proof.r_z, proof.z_omega_z
    alpha_sq = Fr.mul(alpha, alpha)

    as1z = Fr.add(a_z, Fr.add(Fr.mul(beta, s1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mul(beta, s2_z), gamma))

    # r_0 and the quotient evaluation t_z
    r0 = Fr.add(
        Fr.mul(Fr.mul(Fr.mul(alpha, Fr.mul(as1z, bs2z)),
                      Fr.add(c_z, gamma)), zw_z),
        Fr.mul(alpha_sq, l_1_z))
    t_z = Fr.mul(Fr.sub(r_z, r0), Fr.inv(z_h_z))

    # [D] = linearization commitment from the VK
    azg = Fr.add(Fr.add(a_z, Fr.mul(beta, z)), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mul(Fr.mul(beta, k1c), z)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mul(Fr.mul(beta, k2c), z)), gamma)
    z_coef = Fr.add(Fr.mul(Fr.mul(Fr.mul(azg, bzg), czg), alpha),
                    Fr.mul(alpha_sq, l_1_z))
    s3_coef = Fr.mul(Fr.mul(Fr.mul(as1z, bs2z), alpha), Fr.mul(beta, zw_z))
    d_cm = mul(vk.q_m_s, Fr.mul(a_z, b_z))
    d_cm = g1_add(Fq, d_cm, mul(vk.q_l_s, a_z))
    d_cm = g1_add(Fq, d_cm, mul(vk.q_r_s, b_z))
    d_cm = g1_add(Fq, d_cm, mul(vk.q_o_s, c_z))
    d_cm = g1_add(Fq, d_cm, vk.q_c_s)
    d_cm = g1_add(Fq, d_cm, mul(proof.z_s, z_coef))
    d_cm = g1_add(Fq, d_cm, g1_neg(Fq, mul(vk.s_sigma_3_s, s3_coef)))

    # [F] = v-powered combination
    vp = [Fr.pow_static(v, k) for k in range(7)]
    f_cm = proof.t_lo_s
    f_cm = g1_add(Fq, f_cm, mul(proof.t_mid_s, Fr.pow_static(z, n + 2)))
    f_cm = g1_add(Fq, f_cm, mul(proof.t_hi_s, Fr.pow_static(z, 2 * n + 4)))
    f_cm = g1_add(Fq, f_cm, mul(d_cm, vp[1]))
    f_cm = g1_add(Fq, f_cm, mul(proof.a_s, vp[2]))
    f_cm = g1_add(Fq, f_cm, mul(proof.b_s, vp[3]))
    f_cm = g1_add(Fq, f_cm, mul(proof.c_s, vp[4]))
    f_cm = g1_add(Fq, f_cm, mul(vk.s_sigma_1_s, vp[5]))
    f_cm = g1_add(Fq, f_cm, mul(vk.s_sigma_2_s, vp[6]))

    # [E] = batched claimed evaluation * G
    e_scalar = t_z
    for coef, val in ((vp[1], r_z), (vp[2], a_z), (vp[3], b_z),
                      (vp[4], c_z), (vp[5], s1_z), (vp[6], s2_z)):
        e_scalar = Fr.add(e_scalar, Fr.mul(coef, val))
    e_neg = g1_neg(Fq, mul(g, e_scalar))

    ok1 = _kzg_check(Fq, curve, proof.w_z_s, z, f_cm, e_neg, vk.g2_1,
                     vk.g2_s, nb)

    # second opening: z_x at z*omega
    zw_pt = Fr.mul(z, Fr.const(pp.omega))
    e2_neg = g1_neg(Fq, mul(g, zw_z))
    ok2 = _kzg_check(Fq, curve, proof.w_z_omega_s, zw_pt, proof.z_s, e2_neg,
                     vk.g2_1, vk.g2_s, nb)
    return ok1, ok2
