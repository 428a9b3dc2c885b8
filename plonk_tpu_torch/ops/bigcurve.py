"""BN254 G1 over the multi-limb field (`ops/bigfield.py`).

Port of `plonk_tpu/ops/bigcurve.py`: Jacobian points whose coordinates
are (..., limbs) Montgomery-word tensors, Z == 0 the point at infinity;
branchless masked formulas for y^2 = x^3 + 3 (a = 0), generator (1, 2),
prime order r = BN254_FR.p. Independent products of one formula step are
stacked into one `mul_many` call, which cuts launches and leaves the
values as they are.

The fixed-base window table (`BigFixedBaseTable`, `build_big_table`) is
what the table commitments read: T[w][d] = d * 2^(w*wb) * P_i as affine
words. `big_msm_pippenger(_many)` is the bucket MSM over arbitrary points
that the commitments without a table run (directly, or on the GLV split
of `ops/glv.py`); see its section below for how it differs from the JAX
package's sequential scans.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bigfield import BigMontField
from .bigpoly import batch_inv
from ..utils.params import FieldParams

I64 = torch.int64

# BN254 base field (Fq) — the coordinates field; BN254_FR is the scalar.
BN254_FQ = FieldParams(
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    name="BN254-Fq", generator=3, two_adicity=1)

BN254_G1_GEN = (1, 2)
BN254_B = 3


class BigG1J(NamedTuple):
    """Jacobian point batch: tensors (..., limbs); Z == 0 is infinity."""
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor

    @staticmethod
    def identity(F: BigMontField, shape, device) -> "BigG1J":
        one = F.ones(shape, device)
        return BigG1J(one, one, F.zeros(shape, device))


def _sel(mask, a, b):
    return torch.where(mask[..., None], a, b)


def _sel_pt(mask, a: BigG1J, b: BigG1J) -> BigG1J:
    return BigG1J(_sel(mask, a.X, b.X), _sel(mask, a.Y, b.Y),
                  _sel(mask, a.Z, b.Z))


def big_jac_double(F: BigMontField, p: BigG1J) -> BigG1J:
    """2P for a = 0 curves (dbl-2009-l)."""
    A, B, YZ = F.mul_many([(p.X, p.X), (p.Y, p.Y), (p.Y, p.Z)])
    t = F.add(p.X, B)
    E = F.add(F.add(A, A), A)
    Cc, tt, Ff = F.mul_many([(B, B), (t, t), (E, E)])
    D = F.sub(tt, F.add(A, Cc))
    D = F.add(D, D)
    X3 = F.sub(Ff, F.add(D, D))
    C8 = F.add(Cc, Cc)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mont_mul(E, F.sub(D, X3)), C8)
    return BigG1J(X3, Y3, F.add(YZ, YZ))


def big_jac_add(F: BigMontField, p: BigG1J, q: BigG1J) -> BigG1J:
    """Complete Jacobian addition: identity operands, equal points
    (doubling) and inverse points (infinity) are exact, by masks."""
    bt = torch.broadcast_tensors(*p, *q)
    p, q = BigG1J(*bt[:3]), BigG1J(*bt[3:])
    Z1Z1, Z2Z2, Z12 = F.mul_many([(p.Z, p.Z), (q.Z, q.Z), (p.Z, q.Z)])
    U1, U2, Z2c, Z1c = F.mul_many([(p.X, Z2Z2), (q.X, Z1Z1), (q.Z, Z2Z2),
                                   (p.Z, Z1Z1)])
    S1, S2 = F.mul_many([(p.Y, Z2c), (q.Y, Z1c)])
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    HH, rr, Z3 = F.mul_many([(H, H), (r, r), (Z12, H)])
    HHH, V = F.mul_many([(H, HH), (U1, HH)])
    X3 = F.sub(F.sub(rr, HHH), F.add(V, V))
    rV, SH = F.mul_many([(r, F.sub(V, X3)), (S1, HHH)])
    gen = BigG1J(X3, F.sub(rV, SH), Z3)

    dbl = big_jac_double(F, p)
    p_inf = F.is_zero(p.Z)
    q_inf = F.is_zero(q.Z)
    same_x = F.is_zero(H) & ~p_inf & ~q_inf
    r_zero = F.is_zero(r)
    out = _sel_pt(same_x & r_zero, dbl, gen)
    out = BigG1J(out.X, out.Y,
                 _sel(same_x & ~r_zero, torch.zeros_like(out.Z), out.Z))
    out = _sel_pt(p_inf, q, out)
    return _sel_pt(q_inf, p, out)


def big_jac_mul(F: BigMontField, base: BigG1J, scalar_bits,
                nbits: int) -> BigG1J:
    """Masked double-and-add ladder; scalar_bits (..., nbits) 0/1, LSB
    first. Host bits (numpy) skip the addition where no lane has the bit
    set, and the steps above the highest set bit."""
    host = None if isinstance(scalar_bits, torch.Tensor) else \
        np.asarray(scalar_bits)
    if host is not None:
        nbits = host_bit_length(host, nbits)
    bits = torch.as_tensor(scalar_bits, device=base.X.device)
    acc = BigG1J.identity(F, base.X.shape[:-1], base.X.device)
    cur = base
    for i in range(nbits):
        if host is None or host[..., i].any():
            acc = _sel_pt(bits[..., i] == 1, big_jac_add(F, acc, cur), acc)
        if i + 1 < nbits:
            cur = big_jac_double(F, cur)
    return acc


def scalar_to_bits(s: int, nbits: int) -> np.ndarray:
    return np.array([(s >> i) & 1 for i in range(nbits)], dtype=np.int64)


def host_bit_length(bits: np.ndarray, nbits: int) -> int:
    """1 + the highest of the first nbits bit positions set in any lane of
    host bits (..., nbits), 0 when none is."""
    lanes = bits[..., :nbits].reshape(-1, min(nbits, bits.shape[-1]))
    set_ = np.flatnonzero(lanes.any(0))
    return int(set_[-1]) + 1 if set_.size else 0


def big_to_affine(F: BigMontField, p: BigG1J):
    """-> (x, y, inf): Montgomery affine coordinates, zeros at infinity.
    One batched (Montgomery-trick) inversion for the whole batch."""
    zinv = batch_inv(F, p.Z.reshape(-1, F.limbs)).reshape(p.Z.shape)
    zi2 = F.square(zinv)
    x, zi3 = F.mul_many([(p.X, zi2), (zi2, zinv)])
    y = F.mont_mul(p.Y, zi3)
    inf = F.is_zero(p.Z)
    return (_sel(inf, torch.zeros_like(x), x),
            _sel(inf, torch.zeros_like(y), y), inf)


def bn254_generator(F: BigMontField, shape, device) -> BigG1J:
    return BigG1J(F.full(BN254_G1_GEN[0], shape, device),
                  F.full(BN254_G1_GEN[1], shape, device),
                  F.ones(shape, device))


def big_on_curve(F: BigMontField, x, y) -> torch.Tensor:
    """y^2 == x^3 + b (Montgomery affine coordinates)."""
    rhs = F.add(F.mont_mul(F.square(x), x), F.const(BN254_B))
    return F.eq(F.square(y), rhs)


def affine_to_jac(F: BigMontField, x, y, inf) -> BigG1J:
    """Montgomery affine words + infinity mask -> Jacobian (Z = 1, or
    the identity (1, 1, 0) at infinity)."""
    one = F.ones(x.shape[:-1], x.device)
    return BigG1J(_sel(inf, one, x), _sel(inf, one, y),
                  _sel(inf, torch.zeros_like(one), one))


# ---------------- fixed-base window tables ----------------

class BigFixedBaseTable(NamedTuple):
    x: torch.Tensor      # (n_windows, n_buckets, L, limbs) Montgomery
    y: torch.Tensor
    inf: torch.Tensor    # (n_windows, n_buckets, L) bool
    window_bits: int


def build_big_table(F: BigMontField, pts: BigG1J, window_bits: int,
                    scalar_bits: int, chunk: int = 1 << 15
                    ) -> BigFixedBaseTable:
    """T[w][d] = d * 2^(w*wb) * pts as affine words, d = 0 the identity.
    The window bases come from one chain of doublings batched over all
    points; the d-multiples from 2^wb - 2 additions and one batched affine
    conversion, over slices of at most `chunk` (window, point) bases (the
    products hold ~10 KB of temporaries per element)."""
    n_windows = -(-scalar_bits // window_bits)
    nb = 1 << window_bits
    L = pts.X.shape[0]
    bases = [pts]
    for _ in range(n_windows - 1):
        cur = bases[-1]
        for _ in range(window_bits):
            cur = big_jac_double(F, cur)
        bases.append(cur)
    flat = BigG1J(*(torch.stack(c).reshape(n_windows * L, F.limbs)
                    for c in zip(*bases)))                      # (W*L,)
    xs, ys, infs = [], [], []
    for lo in range(0, n_windows * L, chunk):
        base = BigG1J(*(c[lo:lo + chunk] for c in flat))
        mult = [base]
        for _ in range(nb - 2):
            mult.append(big_jac_add(F, mult[-1], base))
        mult = BigG1J(*(torch.stack(c) for c in zip(*mult)))    # (nb-1, l)
        ax, ay, ainf = big_to_affine(F, mult)
        xs.append(ax)
        ys.append(ay)
        infs.append(ainf)
    cat = lambda parts: torch.cat(parts, dim=1).reshape(
        (nb - 1, n_windows, L) + parts[0].shape[2:]).transpose(0, 1)
    x, y, inf = cat(xs), cat(ys), cat(infs)                     # (W,nb-1,L)
    z = torch.zeros((n_windows, 1) + tuple(x.shape[2:]), dtype=I64,
                    device=x.device)
    return BigFixedBaseTable(
        x=torch.cat([z, x], 1).contiguous(),
        y=torch.cat([z, y], 1).contiguous(),
        inf=torch.cat([torch.ones(z.shape[:-1], dtype=torch.bool,
                                  device=x.device), inf], 1).contiguous(),
        window_bits=window_bits)


def big_digits(scalar_words: torch.Tensor, wb: int,
               n_windows: int) -> torch.Tensor:
    """(..., L, n_words) 16-bit scalar words -> (..., W, L) window digits:
    the JAX package's `_big_digits` on (L, n_words) and its
    `_big_digits_batch` on (B, L, n_words)."""
    n_words = scalar_words.shape[-1]
    if 16 % wb == 0:          # windows never straddle words: one shift
        per = 16 // wb
        sh = torch.arange(per, device=scalar_words.device) * wb
        d = (scalar_words[..., None] >> sh) & ((1 << wb) - 1)
        d = d.flatten(-2)[..., :n_windows]                  # (..., L, W)
        return d.transpose(-1, -2)
    out = []
    for w in range(n_windows):
        word, off = divmod(w * wb, 16)
        d = scalar_words[..., word] >> off
        if off + wb > 16 and word + 1 < n_words:
            d = d | (scalar_words[..., word + 1] << (16 - off))
        out.append(d & ((1 << wb) - 1))
    return torch.stack(out, dim=-2)


def big_tree_reduce(F: BigMontField, terms: BigG1J, dim: int,
                    chunk: int = 1 << 16) -> BigG1J:
    """Sum of the points along `dim` by halving levels of complete
    additions (padded with the identity to a power of two). A level wider
    than `chunk` additions runs in slices, bounding the temporaries."""
    n = terms.X.shape[dim]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        shape = list(terms.X.shape[:-1])
        shape[dim] = m - n
        pad = BigG1J.identity(F, shape, terms.X.device)
        terms = BigG1J(*(torch.cat([a, b], dim) for a, b in zip(terms, pad)))
    flat = lambda p: BigG1J(*(c.reshape(-1, F.limbs) for c in p))
    while m > 1:
        h = m // 2
        lo = BigG1J(*(c.narrow(dim, 0, h) for c in terms))
        hi = BigG1J(*(c.narrow(dim, h, h) for c in terms))
        terms = BigG1J(*(c.reshape(lo.X.shape) for c in _add_chunked(
            F, flat(lo), flat(hi), chunk)))
        m = h
    return BigG1J(*(c.select(dim, 0) for c in terms))


def _add_chunked(F: BigMontField, p: BigG1J, q: BigG1J,
                 chunk: int) -> BigG1J:
    """big_jac_add of two flat (N, limbs) batches, `chunk` at a time."""
    n = p.X.shape[0]
    if n <= chunk:
        return big_jac_add(F, p, q)
    parts = [big_jac_add(F, BigG1J(*(c[s:s + chunk] for c in p)),
                         BigG1J(*(c[s:s + chunk] for c in q)))
             for s in range(0, n, chunk)]
    return BigG1J(*(torch.cat(c) for c in zip(*parts)))


def big_fixed_base_mul_many(F: BigMontField, table: BigFixedBaseTable,
                            scalar_words: torch.Tensor) -> BigG1J:
    """s_i * P for each scalar from a one-point window table (the SRS
    generator): scalar_words (B, n_words) standard form -> (B,)
    Jacobian."""
    wb = table.window_bits
    n_windows, nb, L, limbs = table.x.shape
    if L != 1:
        raise ValueError("per-scalar fixed-base requires a 1-point table")
    digits = big_digits(scalar_words, wb, n_windows)          # (W, B)
    widx = torch.arange(n_windows, device=digits.device)[:, None]
    gx = table.x[:, :, 0][widx, digits]                         # (W, B, l)
    gy = table.y[:, :, 0][widx, digits]
    ginf = table.inf[:, :, 0][widx, digits]
    return big_tree_reduce(F, affine_to_jac(F, gx, gy, ginf), dim=0)


# ---------------- Pippenger MSM over arbitrary points ----------------
#
# The JAX package's big_msm_pippenger walks each window's sorted points
# with a chunked sequential scan, reduces the 255 buckets with a
# descending running sum and combines the windows with doublings, all as
# lax loops. Eagerly each sequential step is a whole point operation
# (~10^3 launches), so the port keeps the math and drops the sequence:
#
# - bucket sums by pairwise halving with segment flags over the sorted
#   points of every (lane, window) row at once: ceil(log2 L) levels of
#   one batched addition each, L - 1 additions a row in all. A
#   Hillis-Steele segmented scan would take as many levels but log2(L)
#   times the additions (each level adds over every slot), and it is the
#   additions' temporaries that bound the batch a level can hold;
# - sum_b b S_b over the bits of b: V_k, the sum of the bucket sums whose
#   b has bit k set, for every k at once by one masked tree, then
#   sum_k 2^k V_k by Horner's rule (wb - 1 doublings and additions), in
#   place of 510 sequential additions; only the nonempty buckets take
#   part (at most min(L, 2^wb) a row), which keeps small MSMs small;
# - the windows by Horner's rule (wb doublings and one addition a
#   window): sequential, but on the (B,) lanes alone.
#
# Jacobian representatives depend on the order of addition: compare
# results in affine form (big_to_affine), as the JAX package's bench does.

PIPPENGER_CHUNK = 1 << 17      # point additions per big_jac_add call


def _segment_sums(F: BigMontField, pts: BigG1J, keys: torch.Tensor,
                  n_keys: int, chunk: int) -> BigG1J:
    """Sum of the points of each key of each row: pts (R, m, limbs), keys
    (R, m) ascending along the row, in [0, n_keys) -> (R, n_keys) points,
    the identity where a key has no point.

    Pairwise halving: a node covers a run of the sorted row and holds the
    sum of its first key's points (P, key pk) and of its last key's (S,
    key sk), `single` when the run has one key. Merging L and R adds L.S
    and R.P once; a key whose run lies wholly inside the merged node is
    complete and goes to its slot of the output, every key exactly once
    (slot n_keys takes the rest)."""
    R, m = keys.shape
    dev = keys.device
    out = BigG1J.identity(F, (R * (n_keys + 1),), dev)
    out = BigG1J(*(c.clone() for c in out))
    base = torch.arange(R, device=dev)[:, None] * (n_keys + 1)

    def emit(values: BigG1J, key, valid):
        idx = (base + torch.where(valid, key, n_keys)).reshape(-1)
        for dst, src in zip(out, values):
            dst.index_put_((idx,), src.reshape(-1, F.limbs))

    P = S = pts
    pk = sk = keys
    single = torch.ones_like(keys, dtype=torch.bool)
    while m > 1:
        if m % 2:       # a sentinel node ends the row: its own key, no point
            pad = BigG1J.identity(F, (R, 1), dev)
            P = BigG1J(*(torch.cat([a, b], 1) for a, b in zip(P, pad)))
            S = BigG1J(*(torch.cat([a, b], 1) for a, b in zip(S, pad)))
            fill = torch.full((R, 1), n_keys, dtype=keys.dtype, device=dev)
            pk, sk = torch.cat([pk, fill], 1), torch.cat([sk, fill], 1)
            single = torch.cat([single, torch.ones_like(fill, dtype=torch.bool)],
                               1)
            m += 1
        h = m // 2
        lP, lS = BigG1J(*(c[:, 0::2] for c in P)), BigG1J(*(c[:, 0::2]
                                                            for c in S))
        rP, rS = BigG1J(*(c[:, 1::2] for c in P)), BigG1J(*(c[:, 1::2]
                                                            for c in S))
        lsk, rpk = sk[:, 0::2], pk[:, 1::2]
        ls, rs = single[:, 0::2], single[:, 1::2]
        join = lsk == rpk
        flat = lambda p: BigG1J(*(c.reshape(R * h, F.limbs) for c in p))
        M = BigG1J(*(c.reshape(R, h, F.limbs)
                     for c in _add_chunked(F, flat(lS), flat(rP), chunk)))
        # L's last key ends here unless L is one run that continues into R
        # (or R's whole run joins it); R's first key ends here when it does
        # not join L and R holds another key after it
        emit(BigG1J(*(torch.cat([_sel(join, a, b), c], 1)
                      for a, b, c in zip(M, lS, rP))),
             torch.cat([lsk, rpk], 1),
             torch.cat([~ls & (~join | ~rs), ~join & ~rs], 1))
        P = _sel_pt(ls & join, M, lP)
        S = _sel_pt(rs & join, M, rS)
        pk, sk = pk[:, 0::2], sk[:, 1::2]
        single = ls & rs & join
        m = h
    emit(BigG1J(*(torch.cat([a, b], 1) for a, b in zip(P, S))),
         torch.cat([pk, sk], 1),
         torch.cat([torch.ones_like(single), ~single], 1))
    return BigG1J(*(c.reshape(R, n_keys + 1, F.limbs)[:, :n_keys]
                    for c in out))


def _window_sums(F: BigMontField, pts: BigG1J, keys: torch.Tensor,
                 nb: int, chunk: int) -> BigG1J:
    """sum_i d_i P_i of each row: keys (R, L), the digits in [0, nb) in
    ascending order along the row, and pts (R, L, limbs) in the same
    order -> (R,) points. Each digit's points are summed (_segment_sums
    over the digits' ranks: at most K = min(L, nb) distinct digits a
    row); then, with V_k the sum of the digit sums whose digit has bit k
    set (one masked tree over the K sums for all k at once),
    sum_b b S_b = sum_k 2^k V_k by Horner's rule over the bits."""
    R, L = keys.shape
    dev = keys.device
    K = min(L, nb)
    new = torch.ones_like(keys, dtype=torch.bool)
    new[:, 1:] = keys[:, 1:] != keys[:, :-1]
    rank = torch.cumsum(new, 1) - 1                     # (R, L) in [0, K)
    seg_d = torch.zeros((R, K + 1), dtype=keys.dtype, device=dev)
    seg_d.scatter_(1, torch.where(new, rank, K), keys)  # each rank's digit
    sums = _segment_sums(F, pts, rank, K, chunk)        # (R, K)
    nbits = (nb - 1).bit_length()
    bit = (seg_d[:, None, :K] >> torch.arange(nbits, device=dev)[:, None]
           ) & 1                                         # (R, nbits, K)
    ident = BigG1J.identity(F, (R, nbits, K), dev)
    V = big_tree_reduce(F, _sel_pt(bit == 1, BigG1J(
        *(c[:, None] for c in sums)), ident), dim=2)    # (R, nbits)
    acc = BigG1J(*(c[:, nbits - 1] for c in V))
    for k in range(nbits - 2, -1, -1):
        acc = big_jac_add(F, big_jac_double(F, acc),
                          BigG1J(*(c[:, k] for c in V)))
    return acc


def big_msm_pippenger_many(F: BigMontField, pts: BigG1J,
                           scalar_words: torch.Tensor, window_bits: int = 8,
                           scalar_bits: int = 254,
                           chunk: int = PIPPENGER_CHUNK) -> BigG1J:
    """B MSMs in one batched pass: scalar_words (B, L, n_words) standard
    form, points (L, limbs) shared by every lane or (B, L, limbs) one set
    a lane -> (B,) Jacobian sums sum_i s_i P_i, the same group elements as
    the JAX package's. Every (lane, window) row is sorted by digit, and
    the rows' bucket sums and bucket reductions run together; the windows
    meet by Horner's rule. Additions run `chunk` points at a time (each
    holds ~40 KB of temporaries)."""
    wb = window_bits
    W = -(-scalar_bits // wb)
    B, L = scalar_words.shape[:2]
    dev = scalar_words.device
    keys, order = torch.sort(big_digits(scalar_words, wb, W), dim=-1)
    pts = BigG1J(*(c.reshape(-1, L, F.limbs) for c in pts))
    lane = (torch.arange(B, device=dev) if pts.X.shape[0] > 1
            else torch.zeros(B, dtype=torch.long, device=dev))
    rows = BigG1J(*(c[lane[:, None, None], order].reshape(B * W, L, F.limbs)
                    for c in pts))                      # (B * W, L)
    wtot = _window_sums(F, rows, keys.reshape(B * W, L), 1 << wb, chunk)
    return combine_windows(F, BigG1J(*(c.reshape(B, W, F.limbs)
                                       for c in wtot)), wb)


def combine_windows(F: BigMontField, wtot: BigG1J, wb: int) -> BigG1J:
    """sum_w 2^(w wb) T_w of window totals (B, W, limbs) -> (B,), by
    Horner's rule from the top window: (W - 1) (wb doublings + one
    addition), sequential, each on the B lanes."""
    W = wtot.X.shape[1]
    acc = BigG1J(*(c[:, W - 1] for c in wtot))
    for w in range(W - 2, -1, -1):
        for _ in range(wb):
            acc = big_jac_double(F, acc)
        acc = big_jac_add(F, acc, BigG1J(*(c[:, w] for c in wtot)))
    return acc


def big_msm_pippenger(F: BigMontField, pts: BigG1J,
                      scalar_words: torch.Tensor, window_bits: int = 8,
                      scalar_bits: int = 254) -> BigG1J:
    """sum_i s_i P_i for arbitrary points: scalar_words (L, n_words)
    standard form, points (L, limbs) -> one Jacobian point."""
    out = big_msm_pippenger_many(F, pts, scalar_words[None], window_bits,
                                 scalar_bits)
    return BigG1J(*(c[0] for c in out))
