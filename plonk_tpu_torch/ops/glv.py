"""GLV endomorphism scalar decomposition and MSM for BN254 G1.

Port of `plonk_tpu/ops/glv.py`. BN254 G1 carries the endomorphism
phi(x, y) = (beta x, y) with phi(P) = lam P (beta a primitive cube root of
unity in Fq, lam the matching one mod r). Each 254-bit scalar splits as
k = k1 + k2 lam (mod r) with |k1|, |k2| < 2^131, so the MSM over the 2L
points [P_i | phi(P_i)] walks 17 windows of 8 bits instead of 32.

The constants are derived on the host as the JAX package derives them
(copied here: Tonelli-Shanks roots of -3, the pair checked against a
python-int curve, the short lattice basis from the extended Euclidean
algorithm on (r, lam)). The device decomposition rounds c_i = k g_i / 2^S
with precomputed g_i = floor(|b| 2^S / r), exactly as the host oracle
`glv_decompose_host` does, on (..., 16) standard-form words with the
carry helpers of ops/bigfield.py (relaxed column sums, one fold, one
carry pass), so its magnitudes and signs equal the JAX package's word for
word.
"""
from __future__ import annotations

import functools

import torch

from . import bigcurve as BC
from .bigfield import BigMontField, _W, _MASK, _colsum, _fold, _prop, \
    _to_words, as_words
from ..utils.params import BN254_FR


# ---------------- host constant derivation ----------------


def _sqrt_mod(a: int, p: int) -> int:
    """Tonelli-Shanks (general p); assumes a is a QR mod p."""
    a %= p
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = (t2 * t2) % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, (b * b) % p
        t, r = (t * c) % p, (r * b) % p
    return r


def _cube_roots_of_unity(p: int):
    """The two primitive cube roots of unity mod p (p = 1 mod 3)."""
    s = _sqrt_mod(p - 3, p)                      # sqrt(-3)
    w1 = ((-1 + s) * pow(2, -1, p)) % p
    return w1, (w1 * w1) % p


class _HostG1:
    """Python-int affine arithmetic on y^2 = x^3 + 3 over Fq (None is
    infinity): picks the matching (beta, lam) pair, and is the MSM tests'
    oracle."""

    def __init__(self, q: int):
        self.q = q

    def add(self, P, Q):
        q = self.q
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2 and (y1 + y2) % q == 0:
            return None
        if P == Q:
            lam = 3 * x1 * x1 * pow(2 * y1, -1, q) % q
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, q) % q
        x3 = (lam * lam - x1 - x2) % q
        return x3, (lam * (x1 - x3) - y1) % q

    def mul(self, P, k):
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, P)
            P = self.add(P, P)
            k >>= 1
        return acc


@functools.lru_cache(maxsize=None)
def glv_constants():
    """(beta, lam, basis) with basis = ((a1, b1), (a2, b2)) short vectors
    of the lattice {(x, y): x + y*lam = 0 mod r}; signed python ints."""
    q, r = BC.BN254_FQ.p, BN254_FR.p
    betas = _cube_roots_of_unity(q)
    lams = _cube_roots_of_unity(r)
    curve = _HostG1(q)
    G = BC.BN254_G1_GEN
    beta_lam = None
    for beta in betas:
        for lam in lams:
            if curve.mul(G, lam) == ((beta * G[0]) % q, G[1]):
                beta_lam = (beta, lam)
    if beta_lam is None:
        raise ArithmeticError("no matching (beta, lam) pair")
    beta, lam = beta_lam

    # EEA on (r, lam): rows (r_i, t_i) with s_i*r + t_i*lam = r_i ->
    # (r_i, -t_i) is a lattice vector. Take the first remainder below
    # sqrt(r) and the shorter of its neighbours (Guide to ECC 3.74).
    rows = [(r, 0), (lam, 1)]
    while rows[-1][0] != 0:
        q_i = rows[-2][0] // rows[-1][0]
        rows.append((rows[-2][0] - q_i * rows[-1][0],
                     rows[-2][1] - q_i * rows[-1][1]))
    sqrt_r = int(r ** 0.5) + 1
    m = next(i for i, (ri, _) in enumerate(rows) if ri < sqrt_r)
    a1, b1 = rows[m][0], -rows[m][1]
    c_a, c_b = rows[m - 1][0], -rows[m - 1][1]
    d_a, d_b = rows[m + 1][0], -rows[m + 1][1]
    if c_a * c_a + c_b * c_b <= d_a * d_a + d_b * d_b:
        a2, b2 = c_a, c_b
    else:
        a2, b2 = d_a, d_b
    for (x, y) in ((a1, b1), (a2, b2)):
        if (x + y * lam) % r:
            raise ArithmeticError("basis vector off the lattice")
    return beta, lam, ((a1, b1), (a2, b2))


_S_BITS = 272                     # 17 words; >= 254 + guard for rounding
_KL = 9                           # |ki| < 2^131 -> 9 words


@functools.lru_cache(maxsize=None)
def _decomp_consts():
    """Unsigned magnitudes + signs for the device decomposition."""
    _, lam, ((a1, b1), (a2, b2)) = glv_constants()
    r = BN254_FR.p
    # solving (k, 0) = c1*(a1, b1) + c2*(a2, b2) over Q gives
    # c1 = b2*k/D, c2 = -b1*k/D with D = a1*b2 - a2*b1 = +-r; the device
    # computes ci = (k*gi + 2^(S-1)) >> S with gi = floor(|coef|*2^S/r)
    # and folds the signs (D's included) into the correction terms
    D = a1 * b2 - a2 * b1
    if abs(D) != r:
        raise ArithmeticError("EEA basis determinant must be +-r")
    sD = 1 if D > 0 else -1
    g1 = (abs(b2) << _S_BITS) // r
    g2 = (abs(b1) << _S_BITS) // r
    return dict(
        lam=lam,
        g1=g1, s_c1=(1 if b2 >= 0 else -1) * sD,
        g2=g2, s_c2=(-1 if b1 >= 0 else 1) * sD,
        a1=abs(a1), s_a1=1 if a1 >= 0 else -1,
        b1=abs(b1), s_b1=1 if b1 >= 0 else -1,
        a2=abs(a2), s_a2=1 if a2 >= 0 else -1,
        b2=abs(b2), s_b2=1 if b2 >= 0 else -1,
    )


def glv_decompose_host(k: int):
    """Python-int oracle: k -> (k1, k2) signed with k1 + k2*lam = k
    (mod r), rounding as the device does."""
    C = _decomp_consts()
    half = 1 << (_S_BITS - 1)
    c1 = ((k * C["g1"] + half) >> _S_BITS) * C["s_c1"]
    c2 = ((k * C["g2"] + half) >> _S_BITS) * C["s_c2"]
    a1 = C["a1"] * C["s_a1"]
    b1 = C["b1"] * C["s_b1"]
    a2 = C["a2"] * C["s_a2"]
    b2 = C["b2"] * C["s_b2"]
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    return k1, k2


# ---------------- device decomposition ----------------
#
# Unsigned word vectors (16-bit words in int64), signs as bool masks.


def _wide_mul(a: torch.Tensor, b: int, out_limbs: int) -> torch.Tensor:
    """(..., La) words times the constant b -> (..., out_limbs) exact
    product words (mod 2^(16*out_limbs))."""
    cols = _colsum(a, as_words(_to_words(b, out_limbs), a), out_limbs)
    out, _ = _prop(_fold(cols, a.shape[-1] << (2 * _W)))
    return out


def _add_words(a: torch.Tensor, b) -> torch.Tensor:
    """(a + b) mod 2^(16L), exact words."""
    s, _ = _prop(a + as_words(b, a))
    return s


def _sub_words(a: torch.Tensor, b: torch.Tensor):
    """((a - b) mod 2^(16L), a >= b)."""
    e0 = _to_words(1, a.shape[-1])
    d, ge = _prop(a + (_MASK - b) + as_words(e0, a))
    return d, ge == 1


def glv_decompose(scalar_words: torch.Tensor):
    """(..., 16) standard-form scalar words -> (k1_words, k1_neg,
    k2_words, k2_neg): (..., 9)-word magnitudes and sign masks with
    k1 + k2*lam = k (mod r); equal to glv_decompose_host, zero counted
    as positive."""
    C = _decomp_consts()
    S_words = _S_BITS // _W                        # 17
    wide = S_words + 16                            # enough for k*gi
    half = _to_words(1 << (_S_BITS - 1), wide)

    def mul_high(k, g):
        rounded = _add_words(_wide_mul(k, g, wide), half)
        return rounded[..., S_words:S_words + _KL]  # >> S (word-aligned)

    k = scalar_words.to(torch.int64)
    c1 = mul_high(k, C["g1"])
    c2 = mul_high(k, C["g2"])
    KW = 17                                        # working width
    kw = torch.nn.functional.pad(k, (0, KW - k.shape[-1]))

    def signed_sum(base, terms):
        """base minus the signed terms: the subtracted positives and the
        subtracted negatives in two piles, then |pos - neg| and its sign."""
        pos, neg = base, torch.zeros_like(base)
        for c, coef, sign in terms:
            t = _wide_mul(c, coef, KW)
            if sign > 0:
                neg = _add_words(neg, t)
            else:
                pos = _add_words(pos, t)
        d, ge = _sub_words(pos, neg)
        dneg, _ = _sub_words(neg, pos)
        return torch.where(ge[..., None], d, dneg)[..., :_KL], ~ge

    k1, k1_neg = signed_sum(kw, [(c1, C["a1"], C["s_c1"] * C["s_a1"]),
                                 (c2, C["a2"], C["s_c2"] * C["s_a2"])])
    k2, k2_neg = signed_sum(torch.zeros_like(kw),
                            [(c1, C["b1"], C["s_c1"] * C["s_b1"]),
                             (c2, C["b2"], C["s_c2"] * C["s_b2"])])
    return k1, k1_neg, k2, k2_neg


# ---------------- GLV MSM ----------------


def glv_split_points(F: BigMontField, pts: BC.BigG1J,
                     k1_neg: torch.Tensor, k2_neg: torch.Tensor
                     ) -> BC.BigG1J:
    """[P_i | phi(P_i)] along the point axis, each negated where its
    sub-scalar is negative (Y -> -Y): points (L, limbs) and masks (..., L)
    -> (..., 2L, limbs)."""
    beta, _, _ = glv_constants()
    phiX = F.mont_mul(pts.X, F.const(beta))
    shape = k1_neg.shape + (F.limbs,)
    negY = F.neg(pts.Y)
    y1 = torch.where(k1_neg[..., None], negY, pts.Y)
    y2 = torch.where(k2_neg[..., None], negY, pts.Y)
    return BC.BigG1J(
        X=torch.cat([pts.X.expand(shape), phiX.expand(shape)], -2),
        Y=torch.cat([y1, y2], -2),
        Z=torch.cat([pts.Z.expand(shape)] * 2, -2))


def big_msm_glv_many(F: BigMontField, pts: BC.BigG1J,
                     scalar_words: torch.Tensor, window_bits: int = 8
                     ) -> BC.BigG1J:
    """GLV MSMs of B lanes in one batched pass: scalar_words (B, L, 16)
    standard form, points (L, limbs) -> (B,) Jacobian, the group elements
    of big_msm_pippenger_many: decompose, split the points, and run the
    bucket MSM over 2L points with 131-bit sub-scalars."""
    k1, k1_neg, k2, k2_neg = glv_decompose(scalar_words)
    pts2 = glv_split_points(F, pts, k1_neg, k2_neg)
    pad = lambda m: torch.nn.functional.pad(m, (0, 16 - _KL))
    sc = torch.cat([pad(k1), pad(k2)], -2)
    # |ki| <= ~2^129 + rounding slack -> 131 bits covers it
    return BC.big_msm_pippenger_many(F, pts2, sc, window_bits=window_bits,
                                     scalar_bits=131)


def big_msm_glv(F: BigMontField, pts: BC.BigG1J,
                scalar_words: torch.Tensor, window_bits: int = 8
                ) -> BC.BigG1J:
    """sum_i s_i P_i by GLV: scalar_words (L, 16), points (L, limbs) ->
    one Jacobian point."""
    out = big_msm_glv_many(F, pts, scalar_words[None], window_bits)
    return BC.BigG1J(*(c[0] for c in out))
