"""The toy PLONK prover: port of `plonk_tpu/models/plonk.py` (replaces
src/plonk.h), and the `Proof` container every prover of the port returns.

The 5-round protocol as a staged dataflow over fixed-shape int64 tensors:
- step 2 sigma mapping: one gather over (H | k1*H | k2*H) with the copy
  constraints' 1-based indices (src/plonk.h:142-160);
- step 3: the 11 interpolations as batched INTTs (src/plonk.h:265-275);
- round 2 grand product: the fractions and one prefix-product scan
  (src/plonk.h:320-359);
- round 3 quotient: schoolbook products with static max degrees, divided
  by x^n - 1 in closed form (src/plonk.h:495-510);
- round 5 openings: closed-form division by (x - z) (src/plonk.h:601-617);
- commitments: the naive SRS fold, the fixed-base multiple table, or the
  Pippenger MSM (ops/msm.py); all give the same points.

Batches: the witness columns (..., n), the challenges (..., 5) and the
blinding scalars (..., 9) may carry leading batch dimensions, and every
output then carries them too: one call proves B independent proofs of one
circuit (parallel/batch.py), where the JAX package maps `prove_core` with
`vmap`. Per-proof scalars meet per-proof polynomials as (..., 1) against
(..., L).

The reference's asserts (witness check src/plonk.h:231, acc(omega^n) == 1
src/plonk.h:365-368, zero remainders src/plonk.h:506-510,610,617, the SRS
degree guard src/srs.h:54-56) are returned as `Diagnostics`;
`prove_checked` raises on a failure. The device of the context's SRS is
where a proof runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import ntt as N
from ..ops import poly as P
from ..ops.curve import G1
from ..ops.field import make_field
from ..ops.msm import msm_pippenger
from ..utils.params import PlonkParams, TOY_PLONK
from .constraints import Assignments, Constraints
from .srs import (SRS, srs_commit_naive, srs_commit_table, srs_create,
                  srs_multiple_table)

I64 = torch.int64


class Proof(NamedTuple):
    """9 G1 commitments + 7 scalar-field evaluations (standard form)
    (src/plonk.h:24-41)."""
    a_s: G1
    b_s: G1
    c_s: G1
    z_s: G1
    t_lo_s: G1
    t_mid_s: G1
    t_hi_s: G1
    w_z_s: G1
    w_z_omega_s: G1
    a_z: torch.Tensor
    b_z: torch.Tensor
    c_z: torch.Tensor
    s_sigma_1_z: torch.Tensor
    s_sigma_2_z: torch.Tensor
    r_z: torch.Tensor
    z_omega_z: torch.Tensor


POINT_FIELDS = Proof._fields[:9]
SCALAR_FIELDS = Proof._fields[9:]


class Diagnostics(NamedTuple):
    satisfied: torch.Tensor      # witness check (src/plonk.h:231)
    acc_ok: torch.Tensor         # acc_x(omega^n) == 1 (src/plonk.h:365-368)
    t_rem_zero: torch.Tensor     # t division exact (src/plonk.h:506-510)
    w_z_rem_zero: torch.Tensor   # (src/plonk.h:610)
    w_zw_rem_zero: torch.Tensor  # (src/plonk.h:617)
    srs_fit: torch.Tensor        # committed degrees fit the SRS (src/srs.h:54)

    def all_ok(self) -> torch.Tensor:
        return torch.stack([self.satisfied, self.acc_ok, self.t_rem_zero,
                            self.w_z_rem_zero, self.w_zw_rem_zero,
                            self.srs_fit]).all()


@dataclasses.dataclass(frozen=True)
class PlonkContext:
    """Prover preprocessing (replaces plonk_new, src/plonk.h:53-119): the
    INTT twiddles stand in for the reference's Vandermonde inverse."""
    params: PlonkParams
    srs: SRS
    h_len: int
    use_pippenger: bool = False
    commit_mode: str = "naive"   # "naive" | "table" (fixed-base multiples)

    def __post_init__(self):
        pp = self.params
        r = pp.field.p
        h = [pow(pp.omega, i, r) for i in range(self.h_len)]
        # domain sanity checks (src/plonk.h:74-99)
        if len(set(h)) != self.h_len or pow(pp.omega, self.h_len, r) != 1:
            raise ValueError("omega does not generate a domain of size h_len")
        if pp.k1 % r in h or pp.k2 % r in h:
            raise ValueError("K1 or K2 is in H, which is not allowed")
        if pp.k2 % r in [(x * pp.k1) % r for x in h]:
            raise ValueError("K2 is in k1*H, which is not allowed")

    @property
    def Fr(self):
        return make_field(self.params.field)

    @property
    def Fq(self):
        return make_field(self.params.curve.base)

    @property
    def device(self) -> torch.device:
        return self.srs.g1s.x.device

    def domains_host(self):
        pp, r, n = self.params, self.params.field.p, self.h_len
        h = np.array([pow(pp.omega, i, r) for i in range(n)], dtype=np.int64)
        return h, h * pp.k1 % r, h * pp.k2 % r

    def z_h_coeffs(self) -> np.ndarray:
        """z_H = x^n - 1 (the reference's poly_z(h), src/plonk.h:116, since
        H is the whole order-n domain)."""
        r, n = self.params.field.p, self.h_len
        c = np.zeros(n + 1, dtype=np.int64)
        c[0] = r - 1
        c[n] = 1
        return c


def plonk_new(params: PlonkParams = TOY_PLONK, *, secret: int, n_srs: int,
              h_len: int, srs_mode: str = "reference",
              use_pippenger: bool = False, commit_mode: str = "naive",
              device=None) -> PlonkContext:
    """The context with its SRS on `device` (default: the CUDA card; pass
    device="cpu" for the CPU)."""
    Fq = make_field(params.curve.base)
    srs = srs_create(Fq, params.curve, secret, n_srs, mode=srs_mode,
                     device=device)
    return PlonkContext(params=params, srs=srs, h_len=h_len,
                        use_pippenger=use_pippenger, commit_mode=commit_mode)


def _words(x, device) -> torch.Tensor:
    """Standard-form integers (numpy, list, tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def sigma_to_roots(ctx: PlonkContext, copy) -> torch.Tensor:
    """copy_constraints_to_roots (src/plonk.h:142-160): (n, 2) rows of
    (COPYOF tag, 1-based index) -> sigma values, as one gather."""
    copy = _words(copy, ctx.device)
    table = torch.as_tensor(np.stack(ctx.domains_host()), device=ctx.device)
    return table[copy[..., 0], copy[..., 1] - 1]


def _commit(ctx: PlonkContext, coeffs: torch.Tensor) -> G1:
    Fq = ctx.Fq
    if ctx.commit_mode == "table":
        # cached on the context itself: an id()-keyed cache aliases after
        # garbage collection and serves a table of another SRS
        tbl = getattr(ctx, "_multiple_table", None)
        if tbl is None:
            tbl = srs_multiple_table(Fq, ctx.srs.g1s, ctx.params.field.p)
            object.__setattr__(ctx, "_multiple_table", tbl)
        return srs_commit_table(Fq, tbl, coeffs)
    if ctx.use_pippenger:
        L = min(coeffs.shape[-1], ctx.srs.length)
        g1s = ctx.srs.g1s
        pts = G1(g1s.x[:L], g1s.y[:L], g1s.inf[:L])
        nb = max(ctx.params.field.p.bit_length(), 2)
        return msm_pippenger(Fq, pts, coeffs[..., :L],
                             window_bits=min(nb, 8), scalar_bits=nb)
    return srs_commit_naive(Fq, ctx.srs.g1s, coeffs,
                            scalar_bits=ctx.params.field.p.bit_length())


def _srs_fit(coeffs: torch.Tensor, srs_len: int) -> torch.Tensor:
    """True iff every coefficient beyond the SRS length is zero (the
    reference exits when the effective degree exceeds the SRS,
    src/srs.h:54-56)."""
    if coeffs.shape[-1] <= srs_len:
        return torch.ones(coeffs.shape[:-1], dtype=torch.bool,
                          device=coeffs.device)
    return (coeffs[..., srs_len:] == 0).all(-1)


def prove(ctx: PlonkContext, cons: Constraints, asg: Assignments,
          challenge, rand9, dialect: str = "reference"
          ) -> tuple[Proof, Diagnostics]:
    """The full 5-round prover on host-side circuit objects. `challenge` =
    [alpha, beta, gamma, z, v] (src/plonk.h:16-22), `rand9` = blinding
    scalars b1..b9."""
    dev = ctx.device
    sel = cons.selectors_device(dev)
    selectors = torch.stack([sel["q_l"], sel["q_r"], sel["q_o"], sel["q_m"],
                             sel["q_c"]])
    copies = _words(np.stack([cons.c_a, cons.c_b, cons.c_c]), dev)
    a_w, b_w, c_w = asg.device(dev)
    return prove_core(ctx, selectors, copies, a_w, b_w, c_w, challenge,
                      rand9, dialect=dialect)


def prove_core(ctx: PlonkContext, selectors, copies, a_w, b_w, c_w,
               challenge, rand9, dialect: str = "reference"
               ) -> tuple[Proof, Diagnostics]:
    """Pure-tensor prover core.

    selectors: (5, n) rows [q_l, q_r, q_o, q_m, q_c];
    copies: (3, n, 2) (COPYOF tag, 1-based index) rows [c_a, c_b, c_c];
    a_w/b_w/c_w: (..., n) wire values; challenge (..., 5); rand9 (..., 9).

    dialect: "reference" replicates the reference's linearization r(x) bit
    for bit, including its nonstandard quadratic r3 term z_x * sigma_3
    (src/plonk.h:563-570) and its missing q_c term, which make the proof
    unverifiable from commitments. "standard" computes the PLONK paper's
    degree-1 linearization, which models/verifier.py checks with two
    pairings; the proof layout is the same."""
    if dialect not in ("reference", "standard"):
        raise ValueError(f"unknown dialect {dialect!r}")
    Fr = ctx.Fr
    pp = ctx.params
    r = pp.field.p
    dev = ctx.device
    selectors, copies = _words(selectors, dev), _words(copies, dev)
    a_w, b_w, c_w = (_words(x, dev) for x in (a_w, b_w, c_w))
    challenge, rand9 = _words(challenge, dev), _words(rand9, dev)
    n = a_w.shape[-1]
    if n != ctx.h_len:
        raise ValueError(f"the prover needs n == h_len ({n} != "
                         f"{ctx.h_len})")
    omega, k1, k2 = pp.omega, pp.k1, pp.k2
    alpha, beta, gamma, z, v = (challenge[..., i] for i in range(5))

    def col(s):
        """A per-proof scalar against a per-proof polynomial."""
        return s[..., None]

    q_l, q_r, q_o, q_m, q_c = selectors

    # step 1: witness check (src/plonk.h:231)
    lhs = Fr.add(Fr.add(Fr.mul(q_l, a_w), Fr.mul(q_r, b_w)),
                 Fr.add(Fr.mul(q_o, c_w),
                        Fr.add(Fr.mul(q_m, Fr.mul(a_w, b_w)), q_c)))
    satisfied = (lhs == 0).all(-1)

    # step 2: sigma mappings (src/plonk.h:254-256)
    sigma_1, sigma_2, sigma_3 = (sigma_to_roots(ctx, copies[i])
                                 for i in range(3))

    # step 3: the interpolations (src/plonk.h:265-275): the wires per
    # proof, the circuit's selectors and sigmas once
    f_a_x, f_b_x, f_c_x = N.interpolate(
        Fr, torch.stack([a_w, b_w, c_w], dim=-2), omega).unbind(-2)
    (q_o_x, q_m_x, q_l_x, q_r_x, q_c_x, s_sigma_1, s_sigma_2,
     s_sigma_3) = N.interpolate(
        Fr, torch.stack([q_o, q_m, q_l, q_r, q_c, sigma_1, sigma_2,
                         sigma_3]), omega).unbind(0)

    z_h_x = torch.as_tensor(ctx.z_h_coeffs(), device=dev)

    # round 1: blinded wire polynomials + commitments (src/plonk.h:279-301)
    def blind2(b_hi, b_lo, f):
        blind = torch.stack([b_lo, b_hi], dim=-1)
        return P.padd(Fr, P.pmul_school(Fr, blind, z_h_x), f)

    a_x = blind2(rand9[..., 0], rand9[..., 1], f_a_x)   # len n+2
    b_x = blind2(rand9[..., 2], rand9[..., 3], f_b_x)
    c_x = blind2(rand9[..., 4], rand9[..., 5], f_c_x)
    a_s = _commit(ctx, a_x)
    b_s = _commit(ctx, b_x)
    c_s = _commit(ctx, c_x)

    # round 2: permutation grand product (src/plonk.h:320-379)
    h_np, _, _ = ctx.domains_host()
    w_i = torch.as_tensor(h_np[:n - 1], device=dev)    # omega^{i-1}
    aa, bb, cc = a_w[..., :n - 1], b_w[..., :n - 1], c_w[..., :n - 1]
    k1c, k2c = Fr.const(k1), Fr.const(k2)

    def lin(wv, shift):
        return Fr.add(Fr.mul(col(beta), Fr.mul(wv, shift)), col(gamma))

    def sig(s):
        return Fr.add(Fr.mul(col(beta), s[:n - 1]), col(gamma))

    denom = Fr.mul(Fr.mul(Fr.add(aa, lin(w_i, Fr.const(1))),
                          Fr.add(bb, lin(w_i, k1c))),
                   Fr.add(cc, lin(w_i, k2c)))
    # the sigma polynomials interpolate the sigma vectors on H, so their
    # values at omega^{i-1} are the vectors themselves
    numer = Fr.mul(Fr.mul(Fr.add(aa, sig(sigma_1)), Fr.add(bb, sig(sigma_2))),
                   Fr.add(cc, sig(sigma_3)))
    fractions = Fr.div(denom, numer)
    acc = torch.cat([Fr.ones(fractions.shape[:-1] + (1,), dev),
                     P.scan(Fr.mul, fractions)], dim=-1)
    acc_x = N.interpolate(Fr, acc, omega)
    acc_ok = P.peval(Fr, acc_x, Fr.const(pow(omega, n, r))) == Fr.const(1)

    z_blind = torch.stack([rand9[..., 8], rand9[..., 7], rand9[..., 6]],
                          dim=-1)
    z_x = P.padd(Fr, P.pmul_school(Fr, z_blind, z_h_x), acc_x)   # len n+3
    z_s = _commit(ctx, z_x)

    # round 3: quotient t(x) (src/plonk.h:385-524); PI(x) = 0
    e0 = np.zeros(ctx.h_len, dtype=np.int64)
    e0[0] = 1
    l_1_x = N.interpolate(Fr, torch.as_tensor(e0, device=dev), omega)

    T = 4 * n + 6
    t1 = P.padd(Fr, P.pmul_school(Fr, P.pmul_school(Fr, a_x, b_x), q_m_x),
                P.pmul_school(Fr, a_x, q_l_x))
    t1 = P.padd(Fr, t1, P.pmul_school(Fr, b_x, q_r_x))
    t1 = P.padd(Fr, t1, P.pmul_school(Fr, c_x, q_o_x))
    t1 = P.pad_to(P.padd(Fr, t1, q_c_x), T)

    bxg = torch.stack([gamma, beta], dim=-1)
    bk1g = torch.stack([gamma, Fr.mul(beta, k1c)], dim=-1)
    bk2g = torch.stack([gamma, Fr.mul(beta, k2c)], dim=-1)
    t2 = P.pmul_school(Fr, P.pscale(Fr, P.padd(Fr, a_x, bxg), col(alpha)),
                       P.padd(Fr, b_x, bk1g))
    t2 = P.pmul_school(Fr, t2, P.padd(Fr, c_x, bk2g))
    t2 = P.pad_to(P.pmul_school(Fr, t2, z_x), T)

    omega_pows_z = torch.as_tensor(
        [pow(omega, i, r) for i in range(n + 3)], dtype=I64, device=dev)
    z_omega_x = Fr.mul(z_x, omega_pows_z)        # z(omega x): coeff twist

    def perm_term(w_x, s_x):
        return P.padd_const(Fr, P.padd(Fr, w_x, P.pscale(Fr, s_x, col(beta))),
                            gamma)

    as1 = perm_term(a_x, s_sigma_1)
    bs2 = perm_term(b_x, s_sigma_2)
    cs3 = perm_term(c_x, s_sigma_3)
    t3 = P.pmul_school(Fr, P.pscale(Fr, as1, col(alpha)), bs2)
    t3 = P.pmul_school(Fr, t3, cs3)
    t3 = P.pad_to(P.pmul_school(Fr, t3, z_omega_x), T)

    z_minus_1 = P.padd_const(Fr, z_x, Fr.const(-1))
    alpha_sq = Fr.mul(alpha, alpha)
    t4 = P.pad_to(P.pmul_school(Fr, P.pscale(Fr, z_minus_1, col(alpha_sq)),
                                l_1_x), T)

    t_numer = P.padd(Fr, P.psub(Fr, P.padd(Fr, t1, t2), t3), t4)
    t_x, t_rem = P.divide_by_vanishing(Fr, t_numer, n)   # len 3n+6
    t_rem_zero = (t_rem == 0).all(-1)

    # round 3 split + commitments (src/plonk.h:513-524)
    part = n + 2
    t_lo_x = t_x[..., :part]
    t_mid_x = t_x[..., part:2 * part]
    t_hi_x = t_x[..., 2 * part:]
    t_lo_s = _commit(ctx, t_lo_x)
    t_mid_s = _commit(ctx, t_mid_x)
    t_hi_s = _commit(ctx, t_hi_x)

    # round 4: evaluations at z + linearization (src/plonk.h:527-574)
    a_z = P.peval(Fr, a_x, z)
    b_z = P.peval(Fr, b_x, z)
    c_z = P.peval(Fr, c_x, z)
    s_sigma_1_z = P.peval(Fr, s_sigma_1, z)
    s_sigma_2_z = P.peval(Fr, s_sigma_2, z)
    t_z = P.peval(Fr, t_x, z)
    z_omega_z = P.peval(Fr, z_omega_x, z)

    r_1_x = P.pscale(Fr, q_m_x, col(Fr.mul(a_z, b_z)))
    r_1_x = P.padd(Fr, r_1_x, P.pscale(Fr, q_l_x, col(a_z)))
    r_1_x = P.padd(Fr, r_1_x, P.pscale(Fr, q_r_x, col(b_z)))
    r_1_x = P.padd(Fr, r_1_x, P.pscale(Fr, q_o_x, col(c_z)))

    azg = Fr.add(Fr.add(a_z, Fr.mul(beta, z)), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mul(Fr.mul(beta, k1c), z)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mul(Fr.mul(beta, k2c), z)), gamma)
    r_2_x = P.pscale(Fr, z_x,
                     col(Fr.mul(Fr.mul(Fr.mul(azg, bzg), czg), alpha)))

    as1z = Fr.add(a_z, Fr.add(Fr.mul(beta, s_sigma_1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mul(beta, s_sigma_2_z), gamma))
    l_1_z = P.peval(Fr, l_1_x, z)
    r_4_x = P.pscale(Fr, z_x, col(Fr.mul(l_1_z, alpha_sq)))

    if dialect == "reference":
        # nonstandard quadratic term z_x * sigma_3 (src/plonk.h:558-570)
        s3bz = P.pscale(Fr, s_sigma_3, col(Fr.mul(beta, z_omega_z)))
        r_3_x = P.pscale(Fr, P.pmul_school(Fr, z_x, s3bz),
                         col(Fr.mul(Fr.mul(as1z, bs2z), alpha)))  # len 2n+2
        r_x = P.padd(Fr, P.padd(Fr, P.padd(Fr, r_1_x, r_2_x), r_3_x), r_4_x)
    else:
        # PLONK-paper linearization, degree 1 in the committed polynomials:
        # r = r1 + q_c + r2 - alpha*as1z*bs2z*beta*z_omega_z * sigma_3 + r4
        r_1_x = P.padd(Fr, r_1_x, q_c_x)
        r_3_x = P.pscale(Fr, s_sigma_3,
                         col(Fr.mul(Fr.mul(Fr.mul(as1z, bs2z), alpha),
                                    Fr.mul(beta, z_omega_z))))
        r_x = P.padd(Fr, P.psub(Fr, P.padd(Fr, r_1_x, r_2_x), r_3_x), r_4_x)
    r_z = P.peval(Fr, r_x, z)

    # round 5: opening proofs (src/plonk.h:576-621)
    w = P.padd(Fr, t_lo_x, P.pscale(Fr, t_mid_x,
                                    col(Fr.pow_static(z, n + 2))))
    w = P.padd(Fr, w, P.pscale(Fr, t_hi_x, col(Fr.pow_static(z, 2 * n + 4))))
    w = P.padd_const(Fr, w, Fr.neg(t_z))

    def open_term(poly, eval_at_z, v_pow):
        shifted = P.padd_const(Fr, poly, Fr.neg(eval_at_z))
        return P.pscale(Fr, shifted, col(Fr.pow_static(v, v_pow)))

    w = P.padd(Fr, w, open_term(r_x, r_z, 1))
    w = P.padd(Fr, w, open_term(a_x, a_z, 2))
    w = P.padd(Fr, w, open_term(b_x, b_z, 3))
    w = P.padd(Fr, w, open_term(c_x, c_z, 4))
    w = P.padd(Fr, w, open_term(s_sigma_1, s_sigma_1_z, 5))
    w = P.padd(Fr, w, open_term(s_sigma_2, s_sigma_2_z, 6))

    w_z_x_quo, rem1 = P.divide_by_linear(Fr, w, z)
    z_shift = P.padd_const(Fr, z_x, Fr.neg(z_omega_z))
    zw = Fr.mul(z, Fr.const(omega))
    w_z_omega_x, rem2 = P.divide_by_linear(Fr, z_shift, zw)

    w_z_s = _commit(ctx, w_z_x_quo)
    w_z_omega_s = _commit(ctx, w_z_omega_x)

    srs_fit = torch.stack([
        _srs_fit(c, ctx.srs.length) for c in
        (a_x, b_x, c_x, z_x, t_lo_x, t_mid_x, t_hi_x, w_z_x_quo,
         w_z_omega_x)], dim=-1).all(-1)

    proof = Proof(a_s=a_s, b_s=b_s, c_s=c_s, z_s=z_s, t_lo_s=t_lo_s,
                  t_mid_s=t_mid_s, t_hi_s=t_hi_s, w_z_s=w_z_s,
                  w_z_omega_s=w_z_omega_s, a_z=a_z, b_z=b_z, c_z=c_z,
                  s_sigma_1_z=s_sigma_1_z, s_sigma_2_z=s_sigma_2_z, r_z=r_z,
                  z_omega_z=z_omega_z)
    diags = Diagnostics(satisfied=satisfied, acc_ok=acc_ok,
                        t_rem_zero=t_rem_zero, w_z_rem_zero=rem1 == 0,
                        w_zw_rem_zero=rem2 == 0, srs_fit=srs_fit)
    return proof, diags


def prove_checked(ctx, cons, asg, challenge, rand9,
                  dialect: str = "reference") -> Proof:
    """prove, raising on any invariant failure, as the reference's
    assert/exit does."""
    proof, d = prove(ctx, cons, asg, challenge, rand9, dialect=dialect)
    if not bool(d.satisfied):
        raise AssertionError("constraints not satisfied by assignments")
    if not bool(d.acc_ok):
        raise AssertionError("grand-product accumulator check failed")
    if not bool(d.t_rem_zero):
        raise AssertionError("non-zero remainder in t(x) division")
    if not (bool(d.w_z_rem_zero) and bool(d.w_zw_rem_zero)):
        raise AssertionError("non-zero remainder in opening division")
    if not bool(d.srs_fit):
        raise AssertionError("polynomial degree exceeds SRS size")
    return proof
