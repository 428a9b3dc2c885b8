"""Scaled-curve PLONK prover and verifier.

Port of `plonk_tpu/models/plonk_scaled.py` (single device): the same
5-round protocol over the scaled pairing curve (r = 27*2^22 + 1,
p = 18r - 1), Montgomery fields on both sides, the quotient computed on a
4n coset, and the nine proof commitments made in one batched fixed-base
MSM (K2 on a CUDA device). The prover's transforms are pluggable
(`ProverPrims`): the default prims run every transform's intra-row stages
through K1; `fused_prims`, `onepass_prims` and `mxu2_prims` run the 4n
coset transforms through K5, K6 and K7 on a CUDA device (`_auto_prims`
picks one with PLONK_TPU_NTT). The proof is the same under every prims.

Witnesses, challenges and blinding scalars enter in standard form and the
Proof leaves in standard form; everything between is Montgomery form.
The device of the context's SRS is where a proof runs.

The prover takes a leading batch axis, with the semantics of `jax.vmap`
over the JAX package's prover: (B, n) witness columns with (B, 5)
challenges and (B, 9) blinding give B proofs in the layout `stack_proofs`
builds, one diagnostic flag per lane. A per-lane scalar has the shape
(B,) and meets a (B, L) polynomial as `_col(s)`, (B, 1); the circuit-fixed
tables stay unbatched and broadcast. The batch folds into the rows of
every transform and commitment, so a batch launches K1 and K2 as often as
one proof does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused_ntt as FN
from ..ops import mxu_ntt as MX
from ..ops import ntt as N
from ..ops import poly as P
from ..ops.commit import (build_commit_table, msm_fixed_base_many_kernel,
                          with_packed)
from ..ops.curve import (G1, GT, _sel, g1_add, g1_generator, g1_mul, g1_neg,
                         gt_equal, gt_inv, gt_mul)
from ..ops.field import MontField
from ..ops.fixed_base import FixedBaseTable
from ..ops.pairing import final_exponentiation, miller_loop
from ..utils.diskcache import cache_root, load_npz, save_npz
from ..utils.kernels import resolve_device
from ..utils.params import PlonkParams, scaled_plonk_params
from .plonk import Proof
from .srs import SRS, srs_create

I64 = torch.int64
COMMIT_WINDOW_BITS = 4


class ScaledDiagnostics(NamedTuple):
    """One flag per proof: 0-d for one proof, (B,) for a batch. all_ok
    reduces over every flag of every lane (JAX's jnp.all under vmap)."""
    satisfied: torch.Tensor
    t_tail_zero: torch.Tensor    # quotient degree bound (exact division)
    w_z_rem_zero: torch.Tensor
    w_zw_rem_zero: torch.Tensor

    def all_ok(self) -> torch.Tensor:
        return torch.stack([self.satisfied, self.t_tail_zero,
                            self.w_z_rem_zero, self.w_zw_rem_zero]).all()


@dataclasses.dataclass(frozen=True)
class ScaledContext:
    params: PlonkParams
    srs: SRS
    n: int                       # gates == domain size (power of two)
    coset_shift: int = 7         # generator of F_r^* -> never in any H
    coset_mult: int = 4          # quotient evaluation domain = mult * n

    def __post_init__(self):
        """Domain and coset soundness checks of the permutation argument."""
        pp = self.params
        r = pp.field.p
        n = self.n
        if n & (n - 1) or n < 2:
            raise ValueError("n must be a power of two >= 2")
        w = pp.omega % r
        if pow(w, n, r) != 1 or pow(w, n // 2, r) == 1:
            raise ValueError("omega does not generate a domain of size n")
        # x in H iff x^n == 1 (H is the full n-torsion)
        in_h = lambda x: pow(x % r, n, r) == 1
        if in_h(pp.k1) or in_h(pp.k2):
            raise ValueError("K1 or K2 is in H, which is not allowed")
        if in_h(pp.k2 * pow(pp.k1, -1, r)):
            raise ValueError("K2 is in K1*H, which is not allowed")
        if self.coset_mult < 4 or self.coset_mult & (self.coset_mult - 1):
            raise ValueError("coset_mult must be a power of two >= 4")
        if pow(self.coset_shift % r, self.coset_mult * n, r) == 1:
            raise ValueError("coset_shift is in the evaluation domain")

    @property
    def Fr(self) -> MontField:
        return MontField(self.params.field)

    @property
    def Fq(self) -> MontField:
        return MontField(self.params.curve.base)

    @property
    def device(self) -> torch.device:
        return self.srs.g1s.x.device

    @property
    def domain8(self) -> int:
        """Quotient evaluation domain size (coset_mult * n)."""
        return self.coset_mult * self.n

    def omega(self) -> int:
        return self.params.omega

    def omega8(self) -> int:
        return self.params.field.root_of_unity(self.domain8)


def scaled_new(n: int, secret: int = 123456789, srs_mode: str = "fixed",
               params: PlonkParams | None = None,
               device=None) -> ScaledContext:
    """Trusted setup + context for an n-gate scaled circuit on `device`
    (default: the CUDA card; pass device="cpu" for the CPU)."""
    pp = params if params is not None else scaled_plonk_params(n)
    Fq = MontField(pp.curve.base)
    device = resolve_device(device)
    srs = srs_create(Fq, pp.curve, secret, n + 5, mode=srs_mode,
                     device=device)
    return ScaledContext(params=pp, srs=srs, n=n)


# ---------- host-side tables and small helpers ----------

def _pow_table(p: int, g: int, length: int) -> np.ndarray:
    out = np.empty(length, dtype=np.int64)
    cur = 1
    for i in range(length):
        out[i] = cur
        cur = (cur * g) % p
    return out


def _tree_sum(F, t: torch.Tensor) -> torch.Tensor:
    """Log-depth modular sum along the last axis over contiguous halves."""
    L = t.shape[-1]
    m = 1 << (L - 1).bit_length() if L > 1 else 1
    t = P.pad_to(t, m)
    while m > 1:
        h = m // 2
        t = F.add(t[..., :h], t[..., h:])
        m = h
    return t[..., 0]


def _col(s: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (shape (...)) as a column that broadcasts against
    the lanes' (..., L) vectors."""
    return s[..., None]


def _peval_fast(F, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate (..., L) coefficients at one point per lane, x of shape
    (...), in O(log n) depth."""
    return _tree_sum(F, F.mul(coeffs, P.pow_vector(F, x, coeffs.shape[-1])))


def _as_words(x, device) -> torch.Tensor:
    """Standard-form integers (numpy, list, tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def _sigma_values(ctx: ScaledContext, copies) -> torch.Tensor:
    """(3, n) Montgomery sigma values: copies[i, j] = (column 0..2, 1-based
    row) names the element of H, K1*H or K2*H that wire (i, j) maps to."""
    pp = ctx.params
    r = pp.field.p
    h_std = _pow_table(r, ctx.omega(), ctx.n)
    table = ctx.Fr.array(np.stack([h_std, h_std * pp.k1 % r,
                                   h_std * pp.k2 % r]), ctx.device)
    copies = _as_words(copies, ctx.device)
    return torch.stack([table[copies[i, :, 0], copies[i, :, 1] - 1]
                        for i in range(3)])


# ---------- commitments ----------

def fixed_base_table(ctx: ScaledContext):
    """The SRS window table for fixed-base commitments (window bits 4,
    window axis padded to a power of two), cached on the context object
    and on disk (`_fb_cache_path`): a context whose SRS has a cache file
    loads it instead of building the table."""
    tbl = getattr(ctx, "_fb_table", None)
    if tbl is None:
        wb = COMMIT_WINDOW_BITS
        tbl = _fb_disk_load(ctx, wb)
        if tbl is None:
            tbl = build_commit_table(ctx.Fq, ctx.srs.g1s,
                                     ctx.params.field.p.bit_length(),
                                     window_bits=wb)
            _fb_disk_save(ctx, wb, tbl)
        object.__setattr__(ctx, "_fb_table", tbl)
    return tbl


def _fb_cache_path(ctx: ScaledContext, wb: int) -> str:
    """The table's cache file, under $PLONK_TPU_CACHE (default
    ~/.cache/plonk_tpu). The key is the JAX package's for its Pallas
    layout (`_fb_cache_path(ctx, pts, wb, pallas=True)`): BLAKE2b of the
    SRS's uint32 x and y words and bool infinity flags, then of the two
    moduli, the window bits and "pal"; so each package finds the other's
    files."""
    g1s = ctx.srs.g1s
    h = hashlib.blake2b(digest_size=16)
    h.update(g1s.x.cpu().numpy().astype(np.uint32).tobytes())
    h.update(g1s.y.cpu().numpy().astype(np.uint32).tobytes())
    h.update(g1s.inf.cpu().numpy().astype(bool).tobytes())
    h.update(str((ctx.params.field.p, ctx.params.curve.base.p, wb,
                  "pal")).encode())
    return os.path.join(cache_root(), f"fbtable_{h.hexdigest()}.npz")


def _fb_disk_load(ctx: ScaledContext, wb: int) -> FixedBaseTable | None:
    """The cached table on the context's device (with K2's packed copy on
    a CUDA device), or None when there is no readable cache file."""
    z = load_npz(_fb_cache_path(ctx, wb), ("x", "y", "inf"))
    if z is None:
        return None
    dev = ctx.device
    return with_packed(FixedBaseTable(
        x=torch.as_tensor(z["x"].astype(np.int64), device=dev),
        y=torch.as_tensor(z["y"].astype(np.int64), device=dev),
        inf=torch.as_tensor(z["inf"].astype(bool), device=dev),
        window_bits=wb))


def _fb_disk_save(ctx: ScaledContext, wb: int, tbl: FixedBaseTable) -> None:
    """Write the table's x, y (uint32) and inf (bool), the JAX package's
    npz fields; the packed copy is never cached."""
    save_npz(_fb_cache_path(ctx, wb),
             x=tbl.x.cpu().numpy().astype(np.uint32),
             y=tbl.y.cpu().numpy().astype(np.uint32),
             inf=tbl.inf.cpu().numpy().astype(bool))


def table_commit(ctx: ScaledContext, table):
    """commit_many bound to an explicit window table: (ctx, [k Montgomery
    coefficient vectors of shape (..., L_i)]) -> G1 batch of shape
    (..., k), one K2 launch over the (prod(...) * k, L) rows."""

    def commit(c2, coeff_list):
        L = c2.srs.length
        rows = P.stack_rows([P.pad_to(c, L)[..., :L] for c in coeff_list])
        cms = msm_fixed_base_many_kernel(
            c2.Fq, table, c2.Fr.decode(rows.reshape(-1, L)))
        return G1(*(t.reshape(rows.shape[:-1]) for t in cms))

    return commit


def _commit_many(ctx: ScaledContext, coeff_list) -> G1:
    """Commit a list of Montgomery-form coefficient vectors with one batched
    fixed-base MSM against the context's cached table."""
    return table_commit(ctx, fixed_base_table(ctx))(ctx, coeff_list)


# ---------- the 5-round pipeline, staged ----------

class ProverPrims(NamedTuple):
    """Strategy hooks for the prover's heavy kernels.

    intt_n: (F, vals(..., n), w) -> natural-order coefficients
    ntt8:   (F, coeffs(..., m), w8) -> evaluations (layout defined by perm8)
    intt8:  (F, evals(..., m), w8) -> natural-order coefficients
    grand_product: (F, fractions(..., n-1)) -> accumulator(..., n) =
                   [1, prefix...]
    commit_many:   (ctx, [k coeff vectors (..., L_i)]) -> G1 batch (..., k)
    perm8:  host np table (m,) natural order -> evaluation-order table
    """
    intt_n: object
    ntt8: object
    intt8: object
    grand_product: object
    commit_many: object
    perm8: object


def _prefix_prod_chunked(F, x: torch.Tensor, n_chunks: int = 1024
                         ) -> torch.Tensor:
    """Inclusive prefix product along the last axis of (..., n): running
    products down the columns of an (n/n_chunks, n_chunks) view of each
    lane, then each chunk scaled by the product of the chunks before it."""
    n = x.shape[-1]
    batch = x.shape[:-1]
    n_chunks = min(n_chunks, n)
    while n % n_chunks:
        n_chunks -= 1
    K = n // n_chunks
    cols = x.reshape(batch + (n_chunks, K)).transpose(-1, -2)
    acc = F.ones(batch + (n_chunks,), x.device)
    scans = []
    for k in range(K):
        acc = F.mul(acc, cols[..., k, :])
        scans.append(acc)
    scans = torch.stack(scans, dim=-2)                 # (..., K, n_chunks)
    excl = torch.cat([F.ones(batch + (1,), x.device),
                      P.scan(F.mul, acc)[..., :-1]], dim=-1)
    return F.mul(scans, excl[..., None, :]).transpose(-1, -2).reshape(
        batch + (n,))


def _prefix_prod(F, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the last axis: chunked from 4096
    elements, the doubling scan below."""
    return (_prefix_prod_chunked(F, x) if x.shape[-1] >= 4096
            else P.scan(F.mul, x))


def _local_grand_product(F, fractions: torch.Tensor) -> torch.Tensor:
    return torch.cat([F.ones(fractions.shape[:-1] + (1,), fractions.device),
                      _prefix_prod(F, fractions)], dim=-1)


def default_prims() -> ProverPrims:
    return ProverPrims(
        intt_n=N.intt,
        ntt8=N.ntt,
        intt8=N.intt,
        grand_product=_local_grand_product,
        commit_many=_commit_many,
        perm8=lambda tbl: tbl)


def fused_prims() -> ProverPrims:
    """The 4n coset transforms as the five-step fused transform in
    SCRAMBLED layout (two K5 row passes per call); the pointwise quotient
    algebra is layout-agnostic, and the coset-point table rides perm8."""
    return ProverPrims(
        intt_n=N.intt,
        ntt8=FN.fused_ntt,
        intt8=FN.fused_intt,
        grand_product=_local_grand_product,
        commit_many=_commit_many,
        perm8=lambda tbl: tbl[FN.scrambled_perm(len(tbl))])


def onepass_prims() -> ProverPrims:
    """fused_prims with each coset transform as one K6 launch."""
    return fused_prims()._replace(ntt8=FN.fused_ntt_1k,
                                  intt8=FN.fused_intt_1k)


def mxu_prims() -> ProverPrims:
    """The 4n coset transforms as four-step matmul transforms in the
    transposed (mxu_perm) layout with each modular product in plain
    PyTorch (the float64 limb products of `_mont_mat_transform`): the JAX
    package's plain-XLA matmul prims, which run no TPU kernel, so these
    launch no K7. At the 2^18 coset the products of precompute's 10-row
    stack are (4, 5120, 512) x (512, 2048) float64, a 336 MB product and
    its 336 MB int64 copy; a proof's 5-row stack half that. mxu2_prims
    computes the same proof through K7."""
    return mxu2_prims()._replace(ntt8=MX.mxu_ntt, intt8=MX.mxu_intt)


def mxu2_prims() -> ProverPrims:
    """The 4n coset transforms as four-step matmul transforms in the
    transposed (mxu_perm) layout, each modular product one K7 launch."""
    return ProverPrims(
        intt_n=N.intt,
        ntt8=MX.mxu2_ntt,
        intt8=MX.mxu2_intt,
        grand_product=_local_grand_product,
        commit_many=_commit_many,
        perm8=lambda tbl: tbl[MX.mxu_perm(len(tbl))])


_PRIMS = {"blocked": default_prims, "fused": fused_prims,
          "onepass": onepass_prims, "mxu": mxu_prims, "mxu2": mxu2_prims}


def _auto_prims(ctx: ScaledContext) -> ProverPrims:
    """PLONK_TPU_NTT=blocked|fused|onepass|mxu|mxu2 picks the prims; unset
    or any other value gives the default (blocked) prims."""
    return _PRIMS.get(os.environ.get("PLONK_TPU_NTT"), default_prims)()


def precompute_circuit(ctx: ScaledContext, selectors, copies,
                       prims: ProverPrims | None = None) -> dict:
    """Witness- and challenge-independent circuit tables: selector/sigma
    values, their coefficient polynomials, and their quotient-domain coset
    evaluations (+ L1 and z_H rows), computed once per circuit."""
    Fr = ctx.Fr
    pp = ctx.params
    r = pp.field.p
    n = ctx.n
    m = ctx.domain8
    dev = ctx.device
    omega = ctx.omega()
    w8 = ctx.omega8()
    if prims is None:
        prims = _auto_prims(ctx)

    h_std = _pow_table(r, omega, n)
    sel = Fr.encode(_as_words(selectors, dev))
    sigma_v = _sigma_values(ctx, copies)

    # 9 interpolations: q_o q_m q_l q_r q_c s1 s2 s3 L1
    e0 = Fr.zeros((n,), dev)
    e0[0] = Fr.const(1)
    circ = torch.stack([sel[2], sel[3], sel[0], sel[1], sel[4],
                        sigma_v[0], sigma_v[1], sigma_v[2], e0])
    polys = prims.intt_n(Fr, circ, omega)

    # 10 coset evaluations: the 9 above + z_H
    shift_pows = Fr.array(_pow_table(r, ctx.coset_shift, m), dev)
    zh_coeffs = Fr.zeros((n + 1,), dev)
    zh_coeffs[0] = Fr.const(-1)
    zh_coeffs[n] = Fr.const(1)
    stack10 = torch.cat([P.pad_to(polys, m), P.pad_to(zh_coeffs, m)[None]])
    evs = prims.ntt8(Fr, Fr.mul(stack10, shift_pows), w8)

    return dict(
        sel_v=sel, sigma_v=sigma_v,
        circ_x=polys,            # (9, n) coefficient polys
        circ_e=evs,              # (10, m): qo qm ql qr qc s1 s2 s3 l1 zh
        h_mont=Fr.array(h_std, dev))


def _stage_prep(ctx: ScaledContext, a_w, b_w, c_w, rand9,
                prims: ProverPrims, pre: dict, public_inputs=None) -> dict:
    """Witness-dependent, challenge-independent work: encode, witness
    check, the 3 (+PI) interpolations, round-1 wire blinding. Witness
    columns (..., n), rand9 (..., 9), public inputs (..., n) or None."""
    Fr = ctx.Fr
    n = ctx.n
    dev = ctx.device
    omega = ctx.omega()

    rnd = Fr.encode(_as_words(rand9, dev))
    sel = pre["sel_v"]
    q_l_v, q_r_v, q_o_v, q_m_v, q_c_v = (sel[i] for i in range(5))
    a_v = Fr.encode(_as_words(a_w, dev))
    b_v = Fr.encode(_as_words(b_w, dev))
    c_v = Fr.encode(_as_words(c_w, dev))
    has_pi = public_inputs is not None
    pi_v = (Fr.encode(_as_words(public_inputs, dev)) if has_pi
            else Fr.zeros((n,), dev))

    # step 1: witness check (gate equation incl. PI), one flag per lane
    lhs = Fr.add(
        Fr.add(Fr.add(Fr.mul(q_l_v, a_v), Fr.mul(q_r_v, b_v)), pi_v),
        Fr.add(Fr.mul(q_o_v, c_v),
               Fr.add(Fr.mul(q_m_v, Fr.mul(a_v, b_v)), q_c_v)))
    satisfied = torch.all(lhs == 0, dim=-1)

    # the rows of each lane stacked at -2: (..., 3 or 4, n)
    rows = [a_v, b_v, c_v] + ([pi_v] if has_pi else [])
    polys = prims.intt_n(Fr, P.stack_rows(rows), omega)
    pi_x = polys[..., 3, :] if has_pi else None

    # round 1: blinding via the closed form (b_hi x + b_lo)(x^n - 1),
    # written per lane
    def blind2(b_hi, b_lo, f):
        out = Fr.zeros(b_hi.shape + (n + 2,), dev)
        out[..., 0] = Fr.neg(b_lo)
        out[..., 1] = Fr.neg(b_hi)
        out[..., n] = b_lo
        out[..., n + 1] = b_hi
        return P.padd(Fr, out, f)

    cx = pre["circ_x"]
    return dict(
        rnd=rnd, a_v=a_v, b_v=b_v, c_v=c_v, satisfied=satisfied,
        sigma_1=pre["sigma_v"][0], sigma_2=pre["sigma_v"][1],
        sigma_3=pre["sigma_v"][2],
        q_o_x=cx[0], q_m_x=cx[1], q_l_x=cx[2], q_r_x=cx[3], q_c_x=cx[4],
        s_sigma_1=cx[5], s_sigma_2=cx[6], s_sigma_3=cx[7],
        l_1_x=cx[8], circ_e=pre["circ_e"],
        a_x=blind2(rnd[..., 0], rnd[..., 1], polys[..., 0, :]),
        b_x=blind2(rnd[..., 2], rnd[..., 3], polys[..., 1, :]),
        c_x=blind2(rnd[..., 4], rnd[..., 5], polys[..., 2, :]),
        pi_x=pi_x,
        h_mont=pre["h_mont"])


def _stage_grand_product(ctx: ScaledContext, st: dict, beta, gamma,
                         prims: ProverPrims):
    """Round 2: permutation fractions + prefix product + blinding. beta
    and gamma are per-lane scalars (...). Returns (z_x, denominator_ok),
    one flag per lane."""
    Fr = ctx.Fr
    pp = ctx.params
    n = ctx.n
    beta, gamma = _col(beta), _col(gamma)
    w_i = st["h_mont"][:n - 1]
    k1c, k2c = Fr.const(pp.k1), Fr.const(pp.k2)
    aa, bb, cc = (st[k][..., :n - 1] for k in ("a_v", "b_v", "c_v"))
    denom = Fr.mul(
        Fr.mul(Fr.add(aa, Fr.add(Fr.mul(beta, w_i), gamma)),
               Fr.add(bb, Fr.add(Fr.mul(beta, Fr.mul(w_i, k1c)), gamma))),
        Fr.add(cc, Fr.add(Fr.mul(beta, Fr.mul(w_i, k2c)), gamma)))
    numer = Fr.mul(
        Fr.mul(Fr.add(aa, Fr.add(Fr.mul(beta, st["sigma_1"][:n - 1]), gamma)),
               Fr.add(bb, Fr.add(Fr.mul(beta, st["sigma_2"][:n - 1]), gamma))),
        Fr.add(cc, Fr.add(Fr.mul(beta, st["sigma_3"][:n - 1]), gamma)))
    denominator_ok = torch.logical_and(torch.all(numer != 0, dim=-1),
                                       torch.all(denom != 0, dim=-1))
    fractions = Fr.mul(denom, Fr.inv(numer))
    acc = prims.grand_product(Fr, fractions)
    acc_x = prims.intt_n(Fr, acc, ctx.omega())

    rnd = st["rnd"]
    out = Fr.zeros(rnd.shape[:-1] + (n + 3,), ctx.device)
    out[..., 0] = Fr.neg(rnd[..., 8])
    out[..., 1] = Fr.neg(rnd[..., 7])
    out[..., 2] = Fr.neg(rnd[..., 6])
    out[..., n] = rnd[..., 8]
    out[..., n + 1] = rnd[..., 7]
    out[..., n + 2] = rnd[..., 6]
    return P.padd(Fr, out, acc_x), denominator_ok


def _stage_quotient(ctx: ScaledContext, st: dict, z_x, alpha, beta, gamma,
                    prims: ProverPrims):
    """Round 3: quotient t on a coset of the 4n domain, split in three."""
    Fr = ctx.Fr
    pp = ctx.params
    r = pp.field.p
    n = ctx.n
    m = ctx.domain8
    dev = ctx.device
    omega = ctx.omega()
    w8 = ctx.omega8()
    shift = ctx.coset_shift
    alpha, beta, gamma = _col(alpha), _col(beta), _col(gamma)
    shift_pows = Fr.array(_pow_table(r, shift, m), dev)
    inv_shift_pows = Fr.array(_pow_table(r, pow(shift, -1, r), m), dev)
    omega_pows_z = Fr.array(_pow_table(r, omega, n + 3), dev)
    k1c, k2c = Fr.const(pp.k1), Fr.const(pp.k2)

    # the per-proof forward coset evaluations ride ONE stacked NTT, each
    # lane's rows at -2; the circuit-fixed rows come precomputed from
    # precompute_circuit
    z_omega_x = Fr.mul(z_x, omega_pows_z)
    has_pi = st.get("pi_x") is not None
    rows = [st["a_x"], st["b_x"], st["c_x"], z_x, z_omega_x]
    if has_pi:
        rows.append(st["pi_x"])
    stackp = P.stack_rows([P.pad_to(c, m) for c in rows])
    evs = prims.ntt8(Fr, Fr.mul(stackp, shift_pows), w8)
    a_e, b_e, c_e, z_e, zw_e = (evs[..., i, :] for i in range(5))
    pi_e = evs[..., 5, :] if has_pi else Fr.zeros((m,), dev)
    (qo_e, qm_e, ql_e, qr_e, qc_e, s1_e, s2_e, s3_e, l1_e, zh_e) = (
        st["circ_e"][i] for i in range(10))

    # the coset points g * w8^i, permuted to the ntt8 evaluation order
    pts = Fr.mul(Fr.array(prims.perm8(_pow_table(r, w8, m)), dev),
                 Fr.const(shift))
    t1 = Fr.add(
        Fr.add(Fr.mul(Fr.mul(a_e, b_e), qm_e),
               Fr.add(Fr.mul(a_e, ql_e), pi_e)),
        Fr.add(Fr.mul(b_e, qr_e), Fr.add(Fr.mul(c_e, qo_e), qc_e)))
    t2 = Fr.mul(Fr.mul(Fr.mul(
        Fr.add(a_e, Fr.add(Fr.mul(beta, pts), gamma)),
        Fr.add(b_e, Fr.add(Fr.mul(beta, Fr.mul(pts, k1c)), gamma))),
        Fr.add(c_e, Fr.add(Fr.mul(beta, Fr.mul(pts, k2c)), gamma))),
        Fr.mul(alpha, z_e))
    t3 = Fr.mul(Fr.mul(Fr.mul(
        Fr.add(a_e, Fr.add(Fr.mul(beta, s1_e), gamma)),
        Fr.add(b_e, Fr.add(Fr.mul(beta, s2_e), gamma))),
        Fr.add(c_e, Fr.add(Fr.mul(beta, s3_e), gamma))),
        Fr.mul(alpha, zw_e))
    alpha_sq = Fr.mul(alpha, alpha)
    t4 = Fr.mul(Fr.mul(Fr.sub(z_e, Fr.const(1)), alpha_sq), l1_e)
    t_num_e = Fr.add(Fr.sub(Fr.add(t1, t2), t3), t4)
    t_e = Fr.mul(t_num_e, Fr.inv(zh_e))
    t_full = Fr.mul(prims.intt8(Fr, t_e, w8), inv_shift_pows)
    t_len = 3 * n + 6
    t_x = t_full[..., :t_len]
    t_tail_zero = torch.all(t_full[..., t_len:] == 0, dim=-1)

    part = n + 2
    return dict(z_omega_x=z_omega_x, l_1_x=st["l_1_x"], t_x=t_x,
                t_tail_zero=t_tail_zero,
                t_lo_x=t_x[..., :part], t_mid_x=t_x[..., part:2 * part],
                t_hi_x=t_x[..., 2 * part:])


def _stage_openings(ctx: ScaledContext, st: dict, q3: dict, z_x,
                    alpha, beta, gamma, z, v):
    """Rounds 4+5: evaluations at z, linearization, opening quotients.
    The challenges are per-lane scalars (...)."""
    Fr = ctx.Fr
    pp = ctx.params
    n = ctx.n
    k1c, k2c = Fr.const(pp.k1), Fr.const(pp.k2)
    alpha_sq = Fr.mul(alpha, alpha)
    s_sigma_1, s_sigma_2, s_sigma_3 = (st["s_sigma_1"], st["s_sigma_2"],
                                       st["s_sigma_3"])
    a_x, b_x, c_x = st["a_x"], st["b_x"], st["c_x"]

    a_z = _peval_fast(Fr, a_x, z)
    b_z = _peval_fast(Fr, b_x, z)
    c_z = _peval_fast(Fr, c_x, z)
    s_sigma_1_z = _peval_fast(Fr, s_sigma_1, z)
    s_sigma_2_z = _peval_fast(Fr, s_sigma_2, z)
    t_z = _peval_fast(Fr, q3["t_x"], z)
    z_omega_z = _peval_fast(Fr, q3["z_omega_x"], z)

    # standard linearization (degree-1 in committed polys)
    scale = lambda poly, s: P.pscale(Fr, poly, _col(s))
    r_x = scale(st["q_m_x"], Fr.mul(a_z, b_z))
    r_x = P.padd(Fr, r_x, scale(st["q_l_x"], a_z))
    r_x = P.padd(Fr, r_x, scale(st["q_r_x"], b_z))
    r_x = P.padd(Fr, r_x, scale(st["q_o_x"], c_z))
    r_x = P.padd(Fr, r_x, st["q_c_x"])
    azg = Fr.add(Fr.add(a_z, Fr.mul(beta, z)), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mul(Fr.mul(beta, k1c), z)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mul(Fr.mul(beta, k2c), z)), gamma)
    r_x = P.padd(Fr, r_x, scale(
        z_x, Fr.mul(Fr.mul(Fr.mul(azg, bzg), czg), alpha)))
    as1z = Fr.add(a_z, Fr.add(Fr.mul(beta, s_sigma_1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mul(beta, s_sigma_2_z), gamma))
    r_x = P.psub(Fr, r_x, scale(
        s_sigma_3,
        Fr.mul(Fr.mul(Fr.mul(as1z, bs2z), alpha), Fr.mul(beta, z_omega_z))))
    l_1_z = _peval_fast(Fr, q3["l_1_x"], z)
    r_x = P.padd(Fr, r_x, scale(z_x, Fr.mul(l_1_z, alpha_sq)))
    r_z = _peval_fast(Fr, r_x, z)

    # round 5: opening quotients (closed-form synthetic division)
    w = P.padd(Fr, q3["t_lo_x"],
               scale(q3["t_mid_x"], Fr.pow_static(z, n + 2)))
    w = P.padd(Fr, w, scale(q3["t_hi_x"], Fr.pow_static(z, 2 * n + 4)))
    w = P.padd_const(Fr, w, Fr.neg(t_z))

    def open_term(poly, eval_at_z, v_pow):
        shifted = P.padd_const(Fr, poly, Fr.neg(eval_at_z))
        return scale(shifted, Fr.pow_static(v, v_pow))

    w = P.padd(Fr, w, open_term(r_x, r_z, 1))
    w = P.padd(Fr, w, open_term(a_x, a_z, 2))
    w = P.padd(Fr, w, open_term(b_x, b_z, 3))
    w = P.padd(Fr, w, open_term(c_x, c_z, 4))
    w = P.padd(Fr, w, open_term(s_sigma_1, s_sigma_1_z, 5))
    w = P.padd(Fr, w, open_term(s_sigma_2, s_sigma_2_z, 6))

    w_z_x_quo, rem1 = P.divide_by_linear(Fr, w, z)
    z_shift = P.padd_const(Fr, z_x, Fr.neg(z_omega_z))
    zw = Fr.mul(z, Fr.const(ctx.omega()))
    w_z_omega_x, rem2 = P.divide_by_linear(Fr, z_shift, zw)
    return dict(a_z=a_z, b_z=b_z, c_z=c_z, s_sigma_1_z=s_sigma_1_z,
                s_sigma_2_z=s_sigma_2_z, r_z=r_z, z_omega_z=z_omega_z,
                w_z_x_quo=w_z_x_quo, w_z_omega_x=w_z_omega_x,
                rem1=rem1, rem2=rem2)


def prove_scaled(ctx: ScaledContext, selectors, copies, a_w, b_w, c_w,
                 challenge, rand9, prims: ProverPrims | None = None,
                 public_inputs=None, pre: dict | None = None
                 ) -> tuple[Proof, ScaledDiagnostics]:
    """Scaled 5-round prover. All inputs in STANDARD form: selectors
    (5, n), copies (3, n, 2), witness columns (n,), challenge (5,)
    [alpha beta gamma z v], rand9 (9,), public inputs (n,) or None. With a
    leading batch axis, witness columns (B, n), challenge (B, 5), rand9
    (B, 9) and public inputs (B, n) give B proofs (the layout of
    stack_proofs) and (B,) diagnostics, lane i equal to the proof of lane
    i's inputs.

    The nine commitments are deferred and made in one batched MSM at the
    end: with caller-supplied challenges nothing downstream consumes them.
    `pre` takes precompute_circuit's output; when None the same tables are
    computed inline (identical Proof either way)."""
    Fr = ctx.Fr
    if prims is None:
        prims = _auto_prims(ctx)
    ch = Fr.encode(_as_words(challenge, ctx.device))
    alpha, beta, gamma, z, v = (ch[..., i] for i in range(5))

    if pre is None:
        pre = precompute_circuit(ctx, selectors, copies, prims)
    st = _stage_prep(ctx, a_w, b_w, c_w, rand9, prims, pre, public_inputs)
    z_x, _den_ok = _stage_grand_product(ctx, st, beta, gamma, prims)
    q3 = _stage_quotient(ctx, st, z_x, alpha, beta, gamma, prims)
    q5 = _stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, z, v)

    cms = prims.commit_many(ctx, [st["a_x"], st["b_x"], st["c_x"], z_x,
                                  q3["t_lo_x"], q3["t_mid_x"],
                                  q3["t_hi_x"],
                                  q5["w_z_x_quo"], q5["w_z_omega_x"]])
    pick = lambda i: G1(cms.x[..., i], cms.y[..., i], cms.inf[..., i])

    dec = Fr.decode
    proof = Proof(a_s=pick(0), b_s=pick(1), c_s=pick(2), z_s=pick(3),
                  t_lo_s=pick(4), t_mid_s=pick(5), t_hi_s=pick(6),
                  w_z_s=pick(7), w_z_omega_s=pick(8),
                  a_z=dec(q5["a_z"]), b_z=dec(q5["b_z"]), c_z=dec(q5["c_z"]),
                  s_sigma_1_z=dec(q5["s_sigma_1_z"]),
                  s_sigma_2_z=dec(q5["s_sigma_2_z"]),
                  r_z=dec(q5["r_z"]), z_omega_z=dec(q5["z_omega_z"]))
    diags = ScaledDiagnostics(satisfied=st["satisfied"],
                              t_tail_zero=q3["t_tail_zero"],
                              w_z_rem_zero=q5["rem1"] == 0,
                              w_zw_rem_zero=q5["rem2"] == 0)
    return proof, diags


def make_prover(ctx: ScaledContext, selectors, copies,
                prims: ProverPrims | None = None):
    """Prover for a fixed circuit: the window table and the circuit tables
    are made once here; returns
    fn(a_w, b_w, c_w, challenge, rand9, public_inputs=None)
    -> (Proof, ScaledDiagnostics), for one proof or a batch (see
    prove_scaled)."""
    base = prims if prims is not None else _auto_prims(ctx)
    tbl = fixed_base_table(ctx)
    pre = precompute_circuit(ctx, selectors, copies, base)
    pr = base._replace(commit_many=table_commit(ctx, tbl))

    def fn(a_w, b_w, c_w, ch, rnd, public_inputs=None):
        return prove_scaled(ctx, selectors, copies, a_w, b_w, c_w, ch, rnd,
                            prims=pr, public_inputs=public_inputs, pre=pre)

    return fn


def prove_scaled_checked(ctx: ScaledContext, selectors, copies, a_w, b_w,
                         c_w, challenge, rand9, public_inputs=None
                         ) -> tuple[Proof, ScaledDiagnostics]:
    """The prover with every reference abort as a raised ValueError, with
    the JAX package's messages (its `checkify` lane): the copy tags and
    1-based indices are checked before anything is gathered or launched
    (XLA clamps an index out of range; torch raises on the CPU, and on a
    CUDA device fires an assert that poisons the context), then the four
    diagnostics (src/plonk.h:231, :506-510, :610, :617) after the proof,
    raised if any lane of a batch fails one. Returns (Proof,
    ScaledDiagnostics) otherwise."""
    n = ctx.n
    cps = _as_words(copies, ctx.device)
    if not bool(((cps[..., 0] >= 0) & (cps[..., 0] < 3)).all()):
        raise ValueError("copy tag out of range (must be 0..2)")
    if not bool(((cps[..., 1] >= 1) & (cps[..., 1] <= n)).all()):
        raise ValueError("copy index out of range (1-based, <= n)")
    proof, diags = prove_scaled(ctx, selectors, cps, a_w, b_w, c_w,
                                challenge, rand9,
                                public_inputs=public_inputs)
    for ok, what in (
            (diags.satisfied, "witness does not satisfy the constraints "
                              "(src/plonk.h:231)"),
            (diags.t_tail_zero,
             "quotient division not exact (src/plonk.h:506-510)"),
            (diags.w_z_rem_zero,
             "W_z opening remainder nonzero (src/plonk.h:610)"),
            (diags.w_zw_rem_zero,
             "W_zw opening remainder nonzero (src/plonk.h:617)")):
        if not bool(ok.all()):
            raise ValueError(what)
    return proof, diags


# ---------------- scaled verifier ----------------

class ScaledVK(NamedTuple):
    """Selector/permutation commitments of the scaled circuit."""
    q_m_s: G1
    q_l_s: G1
    q_r_s: G1
    q_o_s: G1
    q_c_s: G1
    s1_s: G1
    s2_s: G1
    s3_s: G1


def make_vk_scaled(ctx: ScaledContext, selectors, copies) -> ScaledVK:
    Fr = ctx.Fr
    sel = Fr.encode(_as_words(selectors, ctx.device))
    sig = _sigma_values(ctx, copies)
    stacked = torch.stack([sel[3], sel[0], sel[1], sel[2], sel[4],
                           sig[0], sig[1], sig[2]])
    # rows: q_m, q_l, q_r, q_o, q_c, s1, s2, s3
    polys = N.intt(Fr, stacked, ctx.omega())
    cms = _commit_many(ctx, [polys[i] for i in range(8)])
    return ScaledVK(*[G1(cms.x[i], cms.y[i], cms.inf[i]) for i in range(8)])


def verify_scaled(ctx: ScaledContext, vk: ScaledVK, proof: Proof,
                  challenge, public_inputs=None) -> bool:
    """Two-pairing KZG verification of a scaled proof: field math in
    Montgomery form, scalar multiplications with decoded standard
    scalars."""
    ok1, ok2 = _verify_scaled_flags(ctx, vk, proof, challenge, public_inputs)
    return bool(ok1) and bool(ok2)


def _verify_points(ctx: ScaledContext, vk: ScaledVK, proof: Proof,
                   challenge, public_inputs=None):
    """The scalar/G1 algebra of verification: returns the two KZG check
    pairs ((W_i, R_i), accept iff e(W_i, [s]_2) == e(R_i, [1]_2)). Takes
    leading batch dimensions: challenge (..., 5), proof fields of shape
    (...), public inputs (..., n); the points come out with shape (...)."""
    Fr, Fq = ctx.Fr, ctx.Fq
    pp = ctx.params
    curve = pp.curve
    r = pp.field.p
    n = ctx.n
    dev = ctx.device
    nbits = r.bit_length()

    ch_std = _as_words(challenge, dev)
    ch = Fr.encode(ch_std)
    alpha, beta, gamma, z, v = (ch[..., i] for i in range(5))
    k1c, k2c = Fr.const(pp.k1), Fr.const(pp.k2)
    g = g1_generator(curve, Fq, dev)
    enc = Fr.encode
    dec = Fr.decode

    a_z, b_z, c_z = enc(proof.a_z), enc(proof.b_z), enc(proof.c_z)
    s1_z, s2_z = enc(proof.s_sigma_1_z), enc(proof.s_sigma_2_z)
    r_z, zw_z = enc(proof.r_z), enc(proof.z_omega_z)
    alpha_sq = Fr.mul(alpha, alpha)

    z_h_z = Fr.sub(Fr.pow_static(z, n), Fr.const(1))
    l_1_z = Fr.mul(Fr.mul(z_h_z, Fr.const(pow(n, -1, r))),
                   Fr.inv(Fr.sub(z, Fr.const(1))))

    as1z = Fr.add(a_z, Fr.add(Fr.mul(beta, s1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mul(beta, s2_z), gamma))
    r0 = Fr.add(
        Fr.mul(Fr.mul(Fr.mul(alpha, Fr.mul(as1z, bs2z)),
                      Fr.add(c_z, gamma)), zw_z),
        Fr.mul(alpha_sq, l_1_z))
    t_z_num = Fr.sub(r_z, r0)
    if public_inputs is not None:
        # PI(z) = (z^n - 1)/n * sum_i pi_i * w^i / (z - w^i)
        pi_v = Fr.encode(_as_words(public_inputs, dev))
        h_mont = Fr.array(_pow_table(r, ctx.omega(), n), dev)
        terms = Fr.mul(Fr.mul(pi_v, h_mont),
                       Fr.inv(Fr.sub(z[..., None], h_mont)))
        pi_z = Fr.mul(Fr.mul(z_h_z, Fr.const(pow(n, -1, r))),
                      _tree_sum(Fr, terms))
        t_z_num = Fr.add(t_z_num, pi_z)
    t_z = Fr.mul(t_z_num, Fr.inv(z_h_z))

    azg = Fr.add(Fr.add(a_z, Fr.mul(beta, z)), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mul(Fr.mul(beta, k1c), z)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mul(Fr.mul(beta, k2c), z)), gamma)
    z_coef = Fr.add(Fr.mul(Fr.mul(Fr.mul(azg, bzg), czg), alpha),
                    Fr.mul(alpha_sq, l_1_z))
    s3_coef = Fr.mul(Fr.mul(Fr.mul(as1z, bs2z), alpha), Fr.mul(beta, zw_z))
    vp = [Fr.pow_static(v, k) for k in range(7)]
    e_scalar = t_z
    for coef, val in ((vp[1], r_z), (vp[2], a_z), (vp[3], b_z),
                      (vp[4], c_z), (vp[5], s1_z), (vp[6], s2_z)):
        e_scalar = Fr.add(e_scalar, Fr.mul(coef, val))
    zw_std = dec(Fr.mul(z, Fr.const(ctx.omega())))

    # every scalar multiplication but [v] D in one batched ladder
    (qm, ql, qr, qo, zs, s3, tmid, thi, a_s, b_s, c_s, s1, s2, ge, gzw, wz,
     wzw) = _mul_many(Fq, [
         (vk.q_m_s, dec(Fr.mul(a_z, b_z))), (vk.q_l_s, dec(a_z)),
         (vk.q_r_s, dec(b_z)), (vk.q_o_s, dec(c_z)),
         (proof.z_s, dec(z_coef)), (vk.s3_s, dec(s3_coef)),
         (proof.t_mid_s, dec(Fr.pow_static(z, n + 2))),
         (proof.t_hi_s, dec(Fr.pow_static(z, 2 * n + 4))),
         (proof.a_s, dec(vp[2])), (proof.b_s, dec(vp[3])),
         (proof.c_s, dec(vp[4])), (vk.s1_s, dec(vp[5])),
         (vk.s2_s, dec(vp[6])), (g, dec(e_scalar)), (g, dec(zw_z)),
         (proof.w_z_s, ch_std[..., 3]), (proof.w_z_omega_s, zw_std)], nbits)
    d_cm = qm
    for term in (ql, qr, qo, vk.q_c_s, zs, g1_neg(Fq, s3)):
        d_cm = g1_add(Fq, d_cm, term)
    (d_v,) = _mul_many(Fq, [(d_cm, dec(vp[1]))], nbits)
    f_cm = proof.t_lo_s
    for term in (tmid, thi, d_v, a_s, b_s, c_s, s1, s2):
        f_cm = g1_add(Fq, f_cm, term)
    r1 = g1_add(Fq, wz, g1_add(Fq, f_cm, g1_neg(Fq, ge)))
    r2 = g1_add(Fq, wzw, g1_add(Fq, proof.z_s, g1_neg(Fq, gzw)))
    return proof.w_z_s, r1, proof.w_z_omega_s, r2


def _mul_many(Fq, pairs, nbits: int) -> list:
    """[(point, standard-form scalar)] -> their products, as one
    double-and-add ladder over a trailing axis of the pairs (each pair
    broadcast to the batch shape of them all)."""
    shape = torch.broadcast_shapes(*(t.shape for pt, sc in pairs
                                     for t in (pt.x, sc)))
    pts = G1(*(torch.stack([pt[k].expand(shape) for pt, _ in pairs], dim=-1)
               for k in range(3)))
    scalars = torch.stack([sc.expand(shape) for _, sc in pairs], dim=-1)
    out = g1_mul(Fq, pts, scalars, nbits=nbits)
    return [G1(out.x[..., j], out.y[..., j], out.inf[..., j])
            for j in range(len(pairs))]


def _stack_g1(pts) -> G1:
    return G1(torch.stack([p.x for p in pts], dim=-1),
              torch.stack([p.y for p in pts], dim=-1),
              torch.stack([p.inf for p in pts], dim=-1))


def _pairing_ratio_checks(ctx: ScaledContext, lhs: G1, rhs: G1):
    """accept[...] iff e(lhs, [s]_2) == e(rhs, [1]_2), elementwise: one
    Miller ratio + one final exponentiation per check."""
    Fq = ctx.Fq
    curve = ctx.params.curve
    one = GT.one(Fq, lhs.x.shape, lhs.x.device)
    mask = lambda inf, t: GT(_sel(inf, one.a, t.a), _sel(inf, one.b, t.b))
    ml_l = mask(lhs.inf, miller_loop(Fq, curve, lhs, ctx.srs.g2_s))
    ml_r = mask(rhs.inf, miller_loop(Fq, curve, rhs, ctx.srs.g2_1))
    ratio = gt_mul(Fq, curve.d, ml_l, gt_inv(Fq, curve.d, ml_r))
    return gt_equal(final_exponentiation(Fq, curve, ratio), one)


def _verify_scaled_flags(ctx: ScaledContext, vk: ScaledVK, proof: Proof,
                         challenge, public_inputs=None):
    w1, r1, w2, r2 = _verify_points(ctx, vk, proof, challenge,
                                    public_inputs)
    oks = _pairing_ratio_checks(ctx, _stack_g1([w1, w2]),
                                _stack_g1([r1, r2]))
    return oks[..., 0], oks[..., 1]


def stack_proofs(proofs) -> Proof:
    """Proofs stacked along a new leading batch axis (verify_scaled_many's
    input)."""
    npts = len(G1._fields)
    return Proof(*(
        G1(*(torch.stack([f[k] for f in fields]) for k in range(npts)))
        if isinstance(fields[0], G1) else torch.stack(fields)
        for fields in zip(*proofs)))


def verify_scaled_many(ctx: ScaledContext, vk: ScaledVK, proofs: Proof,
                       challenges, public_inputs=None) -> torch.Tensor:
    """Batched verification: every field of `proofs` has a leading batch
    axis B, `challenges` is (B, 5) and `public_inputs` None or (B, n).
    The scalar/G1 algebra runs once over the batch, and all 2B pairing
    checks ride one batched Miller loop and one final exponentiation.
    Returns a (B,) bool tensor, lane i equal to verify_scaled of proof i."""
    return torch.logical_and(*_verify_scaled_flags(ctx, vk, proofs,
                                                   challenges, public_inputs))
