"""PLONK over BN254: the production-curve prover and verifier.

Port of `plonk_tpu/models/plonk_bn254.py` (single device): the 5-round
protocol of the scaled prover lifted to 254-bit fields. Scalars are
BN254-Fr word tensors (`ops/bigfield.py`), every 4n-coset transform is
the four-step transform whose row passes are K3 (`ops/bigntt.py`), and
verification runs real optimal-ate pairings over the Fq12 tower
(`ops/bigpairing.py`).

Commitments take one of two routes, chosen as the JAX package chooses:
- the window table: fixed-base MSMs against the SRS's window table (K4,
  `ops/bigcommit.py`, on a CUDA device; its plain version on the CPU),
  when `use_bn254_fixed_base()` holds (PLONK_TPU_BN254_FB=1, or unset on
  a CUDA context), with `bn254_fb_window_bits()`-bit windows
  (PLONK_TPU_BN254_FB_WB, default 4);
- `_commit_many`: bucket MSMs over the SRS points, GLV-split
  (`ops/glv.py`) or plain Pippenger under PLONK_TPU_BN254_GLV=0
  (`ops/bigcurve.py`), no table.
`_local_prims` takes that switch for every BN254 entry point:
make_prover_bn254, make_vk_bn254 and both Fiat-Shamir provers. The JAX
package commits its verifying keys and its FS provers by GLV whatever
the switch says; the route differs, the points are the same.

The SRS (`bn254_setup`) and the window table are cached on disk in the
JAX package's files and fields, so each package loads the other's.

Shapes: a field element is a (16,) tensor of 16-bit words; a polynomial
is (n, 16) with the coefficient axis at -2. Witnesses, challenges and
blinding scalars enter as standard-form word arrays; everything between
is Montgomery form; the proof leaves in standard form. The prover takes
a leading batch axis, with the semantics of `jax.vmap` over the JAX
package's prover: (B, n, 16) witness columns with (B, 5, 16) challenges
and (B, 9, 16) blinding give B proofs in stack_proofs' layout and (B,)
diagnostics. A per-lane scalar (B, 16) meets a (B, L, 16) polynomial as
`_col(s)`, (B, 1, 16); the circuit-fixed tables stay unbatched. The batch
folds into the rows of K3 and of the commitments, so a batch launches K3
and K4 as often as one proof does. The device of the context's SRS is
where a proof runs. The Fiat-Shamir provers over this module's stages
are in models/fiat_shamir.py and models/fs_poseidon.py; the mesh-sharded
prims are parallel/dist_bn254.py's make_dist_bn254_prims.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import bigpoly as BPol
from ..ops import bigpairing as BPair
from ..ops.bigcommit import big_commit_many, pack_commit_table
from ..ops.bigcurve import (BN254_FQ, BigFixedBaseTable, BigG1J,
                            affine_to_jac, big_fixed_base_mul_many,
                            big_jac_add, big_jac_mul, big_msm_pippenger_many,
                            big_to_affine, bn254_generator, build_big_table,
                            scalar_to_bits)
from ..ops.bigfield import BigMontField, big_intt
from ..ops.bigntt import big_fused_intt, big_fused_ntt
from ..ops.fused_ntt import scrambled_perm
from ..ops.glv import big_msm_glv_many
from ..ops.tower import f12_eq, f12_mul, f12_one
from ..utils.diskcache import cache_root, load_npz, save_npz
from ..utils.kernels import resolve_device
from ..utils.params import BN254_FR

I64 = torch.int64
FR_BITS = 254
FR_WORDS = 16
SRS_WINDOW_BITS = 4
MSM_WINDOW_BITS = 8         # _commit_many's windows, the JAX package's


class BigG1Affine(NamedTuple):
    """Affine G1 batch: coordinate words + infinity mask."""
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


class BN254SRS(NamedTuple):
    """KZG setup: g1s[i] = tau^i G (Montgomery affine), g2_1 = H and
    g2_s = tau H as affine twist coordinates (Fq2 tensors (2, 16))."""
    g1s: BigG1Affine
    g2_1x: torch.Tensor
    g2_1y: torch.Tensor
    g2_sx: torch.Tensor
    g2_sy: torch.Tensor
    length: int


class BN254Proof(NamedTuple):
    """9 G1 commitments (standard-form affine words) + 7 Fr evaluations
    (standard-form words)."""
    a_s: BigG1Affine
    b_s: BigG1Affine
    c_s: BigG1Affine
    z_s: BigG1Affine
    t_lo_s: BigG1Affine
    t_mid_s: BigG1Affine
    t_hi_s: BigG1Affine
    w_z_s: BigG1Affine
    w_z_omega_s: BigG1Affine
    a_z: torch.Tensor
    b_z: torch.Tensor
    c_z: torch.Tensor
    s_sigma_1_z: torch.Tensor
    s_sigma_2_z: torch.Tensor
    r_z: torch.Tensor
    z_omega_z: torch.Tensor


POINT_FIELDS = BN254Proof._fields[:9]
SCALAR_FIELDS = BN254Proof._fields[9:]


class BN254Diagnostics(NamedTuple):
    """One flag per proof: 0-d for one proof, (B,) for a batch; all_ok
    reduces over every lane."""
    satisfied: torch.Tensor
    t_tail_zero: torch.Tensor
    w_z_rem_zero: torch.Tensor
    w_zw_rem_zero: torch.Tensor

    def all_ok(self) -> torch.Tensor:
        return torch.stack([self.satisfied, self.t_tail_zero,
                            self.w_z_rem_zero, self.w_zw_rem_zero]).all()


class BN254Prims(NamedTuple):
    """The prover's heavy steps. intt_n: natural order in and out;
    ntt4n may leave any fixed layout that intt4n consumes and perm4n
    aligns position-indexed tables to; grand_product: (F, fractions
    (..., n-1, 16)) -> (..., n, 16) = [1, prefix products...];
    commit_many: list of k coefficient tensors (..., L_i, 16) ->
    BigG1Affine batch of shape (..., k) (Montgomery words)."""
    intt_n: object
    ntt4n: object
    intt4n: object
    grand_product: object
    commit_many: object
    perm4n: object


@dataclasses.dataclass(frozen=True)
class BN254Context:
    srs: BN254SRS
    n: int
    k1: int = 5           # generator of F_r^*: k1^n != 1 for any 2-power n
    k2: int = 25          # k2 = k1^2; k2/k1 = k1 not in H
    coset_shift: int = 5

    def __post_init__(self):
        r = BN254_FR.p
        n = self.n
        if n & (n - 1) or n < 2:
            raise ValueError("n must be a power of two >= 2")
        if 4 * n > 1 << BN254_FR.two_adicity:
            raise ValueError("4n exceeds BN254-Fr's 2-adic domain")
        in_h = lambda x: pow(x % r, n, r) == 1
        if in_h(self.k1) or in_h(self.k2):
            raise ValueError("K1 or K2 is in H")
        if in_h(self.k2 * pow(self.k1, -1, r)):
            raise ValueError("K2 is in K1*H")
        if pow(self.coset_shift % r, 4 * n, r) == 1:
            raise ValueError("coset_shift is in the 4n domain")

    @property
    def Fr(self) -> BigMontField:
        return BigMontField(BN254_FR)

    @property
    def Fq(self) -> BigMontField:
        return BigMontField(BN254_FQ)

    @property
    def device(self) -> torch.device:
        return self.srs.g1s.x.device

    @property
    def omega(self) -> int:
        return BN254_FR.root_of_unity(self.n)

    @property
    def omega4(self) -> int:
        # the quotient's coset domain: deg t = 3n + 5 < 4n
        return BN254_FR.root_of_unity(4 * self.n)


def _words_std(v: int, n_words: int = FR_WORDS) -> list:
    return [(v >> (16 * k)) & 0xFFFF for k in range(n_words)]


def _col(s: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (..., 16) as (..., 1, 16), which broadcasts
    against the lanes' (..., L, 16) vectors."""
    return s[..., None, :]


def _as_words(x, device) -> torch.Tensor:
    """Standard-form words (numpy, list, tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


@functools.lru_cache(maxsize=4)
def _generator_table(device: str) -> BigFixedBaseTable:
    """The one-point window table of the G1 generator, made once per
    device."""
    Fq = BigMontField(BN254_FQ)
    return build_big_table(Fq, bn254_generator(Fq, (1,), device),
                           SRS_WINDOW_BITS, FR_BITS)


def bn254_setup(n: int, secret: int = 20260817, device=None,
                cache: bool = True) -> BN254Context:
    """Trusted setup: the tau-power SRS over BN254 (length n + 5) on
    `device` (default: the CUDA card; pass device="cpu" for the CPU).
    The G1 powers come from a one-point window table of the generator;
    the JAX package uses 8-bit windows there, this port 4-bit ones (the
    points are the same). With `cache` the SRS is read from, or written
    to, the JAX package's file ~/.cache/plonk_tpu/bn254_srs_n{n}_s{secret}
    .npz (uint32 Montgomery words; not under $PLONK_TPU_CACHE, as in the
    JAX package)."""
    device = resolve_device(device)
    path = os.path.join(os.path.expanduser("~/.cache/plonk_tpu"),
                        f"bn254_srs_n{n}_s{secret}.npz")
    if cache and os.path.exists(path):
        return BN254Context(srs=_srs_disk_load(path, device), n=n)
    r = BN254_FR.p
    Fq = BigMontField(BN254_FQ)
    tau = secret % r
    length = n + 5
    pows = []
    cur = 1
    for _ in range(length):
        pows.append(_words_std(cur))
        cur = cur * tau % r
    g1s_jac = big_fixed_base_mul_many(
        Fq, _generator_table(str(device)),
        torch.tensor(pows, dtype=I64, device=device))
    g1s = BigG1Affine(*big_to_affine(Fq, g1s_jac))

    g2 = BPair.g2_generator(Fq, (), device)
    g2s = BPair.g2_mul_bits(Fq, g2, scalar_to_bits(tau, FR_BITS), FR_BITS)
    g2_1x, g2_1y, _ = BPair.g2_to_affine(Fq, g2)
    g2_sx, g2_sy, _ = BPair.g2_to_affine(Fq, g2s)
    srs = BN254SRS(g1s=g1s, g2_1x=g2_1x, g2_1y=g2_1y, g2_sx=g2_sx,
                   g2_sy=g2_sy, length=length)
    if cache:
        u32 = lambda t: t.cpu().numpy().astype(np.uint32)
        save_npz(path, x=u32(g1s.x), y=u32(g1s.y),
                 inf=g1s.inf.cpu().numpy().astype(bool),
                 g2_1x=u32(g2_1x), g2_1y=u32(g2_1y), g2_sx=u32(g2_sx),
                 g2_sy=u32(g2_sy), length=length)
    return BN254Context(srs=srs, n=n)


def _srs_disk_load(path: str, device) -> BN254SRS:
    """The SRS of a cache file (either package's) on `device`. As in the
    JAX package, an unreadable file raises."""
    from ..utils.convert import bn254_srs_from_numpy
    with np.load(path) as z:
        return bn254_srs_from_numpy(
            *(z[k] for k in ("x", "y", "inf", "g2_1x", "g2_1y", "g2_sx",
                             "g2_sy")), int(z["length"]), device)


# ---------- host tables ----------

@functools.lru_cache(maxsize=8)
def _host_tables(n: int, k1: int, k2: int, shift: int) -> dict:
    """Montgomery-encoded domain tables (int64 words), per (n, cosets)."""
    r = BN254_FR.p
    F = BigMontField(BN254_FR)
    omega = BN254_FR.root_of_unity(n)
    w4 = BN254_FR.root_of_unity(4 * n)
    m = 4 * n
    h_std = [pow(omega, i, r) for i in range(n)]
    enc = lambda xs: F.encode_host(np.array(xs, dtype=object))
    inv_shift = pow(shift, -1, r)
    return dict(
        h=enc(h_std),
        k1h=enc([x * k1 % r for x in h_std]),
        k2h=enc([x * k2 % r for x in h_std]),
        shift_pows=enc([pow(shift, i, r) for i in range(m)]),
        inv_shift_pows=enc([pow(inv_shift, i, r) for i in range(m)]),
        omega_pows=enc([pow(omega, i, r) for i in range(n + 3)]),
        coset_pts=enc([shift * pow(w4, i, r) % r for i in range(m)]),
        n_inv=enc([pow(n, -1, r)])[0],
    )


def _tables(ctx: BN254Context) -> dict:
    """_host_tables as tensors on the context's device, made once per
    context and cached on it."""
    tabs = getattr(ctx, "_dev_tables", None)
    if tabs is None:
        host = _host_tables(ctx.n, ctx.k1, ctx.k2, ctx.coset_shift)
        tabs = {k: torch.as_tensor(v, device=ctx.device)
                for k, v in host.items()}
        object.__setattr__(ctx, "_dev_tables", tabs)
    return tabs


def _sigma_values(ctx: BN254Context, copies) -> torch.Tensor:
    """(3, n, 16) Montgomery sigma values of the copy permutation."""
    tabs = _tables(ctx)
    table = torch.stack([tabs["h"], tabs["k1h"], tabs["k2h"]])
    cp = _as_words(copies, ctx.device)
    return torch.stack([table[cp[i, :, 0], cp[i, :, 1] - 1]
                        for i in range(3)])


# ---------- commitments ----------

def use_bn254_fixed_base(device) -> bool:
    """Whether commitments on `device` go through the window table:
    PLONK_TPU_BN254_FB=1 or =0 decides; unset, on for a CUDA device and
    off on the CPU, as the JAX package is on for an accelerator backend
    and off on its CPU backend."""
    flag = os.environ.get("PLONK_TPU_BN254_FB")
    if flag is not None:
        return flag == "1"
    return torch.device(device).type == "cuda"


def bn254_fb_window_bits() -> int:
    """The window table's window width, PLONK_TPU_BN254_FB_WB (default 4,
    the JAX package's). K4 and its plain version read the width from the
    table and read a digit from at most two 16-bit words, so a width
    outside 1..16 raises ValueError."""
    wb = int(os.environ.get("PLONK_TPU_BN254_FB_WB", "4"))
    if not 1 <= wb <= 16:
        raise ValueError(f"PLONK_TPU_BN254_FB_WB={wb}: the window table "
                         "takes widths of 1 to 16 bits")
    return wb


def _fb_cache_path(ctx: BN254Context, wb: int) -> str:
    """The window table's cache file, the JAX package's: under
    $PLONK_TPU_CACHE (default ~/.cache/plonk_tpu), keyed by BLAKE2b of
    the SRS's uint32 Montgomery x words, then of str((length, wb))."""
    h = hashlib.blake2b(digest_size=16)
    h.update(ctx.srs.g1s.x.cpu().numpy().astype(np.uint32).tobytes())
    h.update(str((ctx.srs.length, wb)).encode())
    return os.path.join(cache_root(), f"bn254_fbtbl_{h.hexdigest()}.npz")


def _fb_disk_load(ctx: BN254Context, wb: int) -> BigFixedBaseTable | None:
    """The cached table on the context's device, or None when there is no
    readable cache file (the JAX package rebuilds then too)."""
    from ..utils.convert import big_table_from_numpy
    z = load_npz(_fb_cache_path(ctx, wb), ("x", "y", "inf"))
    return None if z is None else big_table_from_numpy(
        z["x"], z["y"], z["inf"], wb, ctx.device)


def bn254_fixed_base_table(ctx: BN254Context) -> BigFixedBaseTable:
    """The SRS window table for fixed-base commitments at
    bn254_fb_window_bits() (4 by default: 64 windows x 16 buckets x L
    points, Montgomery affine words): loaded from its disk cache or built
    and written there, once per context and width. On a CUDA context its
    packed form for K4 (`pack_commit_table`, never cached on disk) is made
    with it and kept beside it (`bn254_packed_table`)."""
    wb = bn254_fb_window_bits()
    tables = ctx.__dict__.setdefault("_bn254_fb_tables", {})
    if wb not in tables:
        tbl = _fb_disk_load(ctx, wb)
        if tbl is None:
            Fq = ctx.Fq
            g = ctx.srs.g1s
            tbl = build_big_table(Fq, affine_to_jac(Fq, g.x, g.y, g.inf),
                                  wb, FR_BITS)
            u32 = lambda t: t.cpu().numpy().astype(np.uint32)
            save_npz(_fb_cache_path(ctx, wb), x=u32(tbl.x), y=u32(tbl.y),
                     inf=tbl.inf.cpu().numpy().astype(bool))
        packed = (pack_commit_table(tbl) if tbl.x.device.type == "cuda"
                  else None)
        tables[wb] = (tbl, packed)
    return tables[wb][0]


def bn254_packed_table(ctx: BN254Context) -> torch.Tensor | None:
    """K4's packed window table of a CUDA context (None on the CPU, whose
    commitments take the plain version over the int64 table)."""
    bn254_fixed_base_table(ctx)
    return ctx._bn254_fb_tables[bn254_fb_window_bits()][1]


def _commit_rows(ctx: BN254Context, coeff_list, msm) -> BigG1Affine:
    """The k coefficient tensors (..., L_i, 16) of `coeff_list`, padded
    to the SRS length, decoded to standard-form scalars and committed by
    msm((prod(...) * k, L, 16) scalars) -> Jacobian batch: a BigG1Affine
    batch of shape (..., k) (Montgomery words)."""
    Fr, Fq = ctx.Fr, ctx.Fq
    L = ctx.srs.length
    rows = BPol.stack_rows([BPol.pad_to(c, L)[..., :L, :]
                            for c in coeff_list])
    batch = rows.shape[:-2]
    x, y, inf = big_to_affine(Fq, msm(Fr.decode(
        rows.reshape((-1,) + rows.shape[-2:]))))
    return BigG1Affine(x.reshape(batch + x.shape[-1:]),
                       y.reshape(batch + y.shape[-1:]), inf.reshape(batch))


def bn254_table_commit(ctx: BN254Context):
    """commit_many through the context's window table (built or loaded at
    the first commitment): list of k coefficient tensors (..., L_i, 16)
    -> BigG1Affine batch of shape (..., k) (Montgomery words), one K4
    launch over all prod(...) * k commitments on the card."""
    return lambda coeff_list: _commit_rows(
        ctx, coeff_list, lambda sc: big_commit_many(
            ctx.Fq, bn254_fixed_base_table(ctx), sc,
            bn254_packed_table(ctx)))


def _commit_many(ctx: BN254Context, coeff_list) -> BigG1Affine:
    """commit_many without a table: bucket MSMs of all the commitments in
    one batched pass over the SRS points, GLV-split with 8-bit windows
    (ops/glv.py), or the plain 254-bit Pippenger walk under
    PLONK_TPU_BN254_GLV=0; the JAX package's switch and windows. The same
    points as the table route."""
    Fq = ctx.Fq
    g = ctx.srs.g1s
    pts = affine_to_jac(Fq, g.x, g.y, g.inf)
    if os.environ.get("PLONK_TPU_BN254_GLV", "1") != "0":
        msm = lambda sc: big_msm_glv_many(Fq, pts, sc, MSM_WINDOW_BITS)
    else:
        msm = lambda sc: big_msm_pippenger_many(Fq, pts, sc, MSM_WINDOW_BITS,
                                                FR_BITS)
    return _commit_rows(ctx, coeff_list, msm)


def _local_prims(ctx: BN254Context) -> BN254Prims:
    """The single-device prims; commit_many takes the window table when
    use_bn254_fixed_base(ctx.device) holds, else _commit_many."""
    dev = str(ctx.device)
    commit = (bn254_table_commit(ctx) if use_bn254_fixed_base(ctx.device)
              else lambda coeff_list: _commit_many(ctx, coeff_list))
    return BN254Prims(
        intt_n=lambda F, x: big_intt(F, x, ctx.omega),
        ntt4n=lambda F, x: big_fused_ntt(F, x, ctx.omega4),
        intt4n=lambda F, x: big_fused_intt(F, x, ctx.omega4),
        grand_product=lambda F, fr: torch.cat(
            [F.ones(fr.shape[:-2] + (1,), fr.device),
             BPol.prefix_prod_chunked(F, fr)], dim=-2),
        commit_many=commit,
        perm4n=lambda tbl: tbl[torch.as_tensor(scrambled_perm(len(tbl)),
                                               device=dev)])


# ---------- the staged pipeline ----------

def precompute_bn254(ctx: BN254Context, selectors, copies,
                     prims: BN254Prims) -> dict:
    """Witness- and challenge-independent circuit tables: selector and
    sigma values, their 9 coefficient polynomials (q_o q_m q_l q_r q_c s1
    s2 s3 L1) and their 4n-coset evaluations, plus the inverse z_H coset
    row. A fixed circuit pays this once."""
    Fr = ctx.Fr
    n, m = ctx.n, 4 * ctx.n
    dev = ctx.device
    tabs = _tables(ctx)
    sel = Fr.encode(_as_words(selectors, dev))             # (5, n, 16)
    sigma_v = _sigma_values(ctx, copies)
    e0 = Fr.zeros((n,), dev)
    e0[0] = torch.as_tensor(Fr.const(1), device=dev)
    # selector rows are q_l q_r q_o q_m q_c
    circ = torch.stack([sel[2], sel[3], sel[0], sel[1], sel[4],
                        sigma_v[0], sigma_v[1], sigma_v[2], e0])
    polys = prims.intt_n(Fr, circ)
    zh = Fr.zeros((n + 1,), dev)
    zh[0] = torch.as_tensor(Fr.const(-1), device=dev)
    zh[n] = torch.as_tensor(Fr.const(1), device=dev)
    stack10 = torch.stack([BPol.pad_to(polys[i], m) for i in range(9)]
                          + [BPol.pad_to(zh, m)])
    evs = prims.ntt4n(Fr, Fr.mont_mul(stack10, tabs["shift_pows"]))
    # row 9 is stored inverted (z_H never vanishes on the coset): one
    # batched inversion gives the same words as the JAX package's inv
    circ_e = torch.cat([evs[:9], BPol.batch_inv(Fr, evs[9])[None]])
    return dict(sel_v=sel, sigma_v=sigma_v, circ_x=polys, circ_e=circ_e,
                h_mont=tabs["h"])


def _stage_prep(ctx: BN254Context, a_w, b_w, c_w, rand9, prims, pre,
                public_inputs=None):
    """Encode, witness check, the 4 witness interpolations, round-1
    blinding. Witness columns (..., n, 16), rand9 (..., 9, 16), public
    inputs (..., n, 16) or None."""
    Fr = ctx.Fr
    n = ctx.n
    dev = ctx.device
    rnd = Fr.encode(_as_words(rand9, dev))
    q_l_v, q_r_v, q_o_v, q_m_v, q_c_v = pre["sel_v"].unbind(0)
    a_v, b_v, c_v = (Fr.encode(_as_words(w, dev)) for w in (a_w, b_w, c_w))
    pi_v = (Fr.zeros((n,), dev) if public_inputs is None
            else Fr.encode(_as_words(public_inputs, dev)))
    ql_a, qr_b, qo_c, ab = Fr.mul_many([(q_l_v, a_v), (q_r_v, b_v),
                                        (q_o_v, c_v), (a_v, b_v)])
    lhs = Fr.add(Fr.add(Fr.add(ql_a, qr_b), pi_v),
                 Fr.add(qo_c, Fr.add(Fr.mont_mul(q_m_v, ab), q_c_v)))
    satisfied = (lhs == 0).flatten(-2).all(-1)

    # the rows of each lane stacked at -3: (..., 4, n, 16)
    polys = prims.intt_n(Fr, BPol.stack_rows([a_v, b_v, c_v, pi_v]))

    # round 1: (b_hi x + b_lo)(x^n - 1), written per lane
    def blind2(b_hi, b_lo, f):
        out = Fr.zeros(b_hi.shape[:-1] + (n + 2,), dev)
        out[..., 0, :], out[..., 1, :] = Fr.neg(b_lo), Fr.neg(b_hi)
        out[..., n, :], out[..., n + 1, :] = b_lo, b_hi
        return BPol.padd(Fr, out, f)

    cx = pre["circ_x"]
    r = lambda i: rnd[..., i, :]
    return dict(
        rnd=rnd, a_v=a_v, b_v=b_v, c_v=c_v, satisfied=satisfied,
        sigma_1=pre["sigma_v"][0], sigma_2=pre["sigma_v"][1],
        sigma_3=pre["sigma_v"][2],
        q_o_x=cx[0], q_m_x=cx[1], q_l_x=cx[2], q_r_x=cx[3], q_c_x=cx[4],
        s_sigma_1=cx[5], s_sigma_2=cx[6], s_sigma_3=cx[7],
        l_1_x=cx[8], circ_e=pre["circ_e"],
        a_x=blind2(r(0), r(1), polys[..., 0, :, :]),
        b_x=blind2(r(2), r(3), polys[..., 1, :, :]),
        c_x=blind2(r(4), r(5), polys[..., 2, :, :]),
        pi_x=polys[..., 3, :, :], h_mont=pre["h_mont"])


def _stage_grand_product(ctx: BN254Context, st, beta, gamma, prims):
    """Round 2: permutation fractions, prefix product, blinding. beta and
    gamma are per-lane scalars (..., 16). Returns (z_x, denominator_ok),
    one flag per lane."""
    Fr = ctx.Fr
    n = ctx.n
    beta, gamma = _col(beta), _col(gamma)
    w_i = st["h_mont"][:n - 1]
    aa, bb, cc = (st[k][..., :n - 1, :] for k in ("a_v", "b_v", "c_v"))
    bw = Fr.mont_mul(beta, w_i)
    k1bw, k2bw, bs1, bs2, bs3 = Fr.mul_many([
        (Fr.const(ctx.k1), bw), (Fr.const(ctx.k2), bw),
        (beta, st["sigma_1"][:n - 1]), (beta, st["sigma_2"][:n - 1]),
        (beta, st["sigma_3"][:n - 1])])
    shape = torch.broadcast_shapes(aa.shape, bw.shape)
    lin = Fr.add(torch.stack([t.expand(shape)
                              for t in (aa, bb, cc, aa, bb, cc)]),
                 Fr.add(torch.stack([bw, k1bw, k2bw, bs1, bs2, bs3]),
                        gamma))
    pair = Fr.mont_mul(lin[[0, 3]], lin[[1, 4]])
    denom, numer = Fr.mont_mul(pair, lin[[2, 5]]).unbind(0)
    # a vanishing factor makes the later t-division fail, as the
    # reference's remainder assert does (src/plonk.h:506-510); the FS
    # provers retry on a fresh nonce when a product vanishes
    denominator_ok = ((numer != 0).any(-1).all(-1)
                      & (denom != 0).any(-1).all(-1))
    fractions = Fr.mont_mul(denom, BPol.batch_inv(Fr, numer))
    acc_x = prims.intt_n(Fr, prims.grand_product(Fr, fractions))
    rnd = st["rnd"]
    out = Fr.zeros(rnd.shape[:-2] + (n + 3,), ctx.device)
    r = lambda i: rnd[..., i, :]
    out[..., 0, :], out[..., 1, :], out[..., 2, :] = (
        Fr.neg(r(8)), Fr.neg(r(7)), Fr.neg(r(6)))
    out[..., n, :], out[..., n + 1, :], out[..., n + 2, :] = r(8), r(7), r(6)
    return BPol.padd(Fr, out, acc_x), denominator_ok


def _stage_quotient(ctx: BN254Context, st, z_x, alpha, beta, gamma,
                    prims):
    """Round 3: the quotient on the 4n coset (K3 in both transforms),
    split in three."""
    Fr = ctx.Fr
    n, m = ctx.n, 4 * ctx.n
    tabs = _tables(ctx)
    alpha, beta, gamma = _col(alpha), _col(beta), _col(gamma)
    z_omega_x = Fr.mont_mul(z_x, tabs["omega_pows"][:z_x.shape[-2]])
    stack6 = BPol.stack_rows([BPol.pad_to(c, m) for c in (
        st["a_x"], st["b_x"], st["c_x"], z_x, z_omega_x, st["pi_x"])])
    evs = prims.ntt4n(Fr, Fr.mont_mul(stack6, tabs["shift_pows"]))
    a_e, b_e, c_e, z_e, zw_e, pi_e = evs.unbind(-3)
    (qo_e, qm_e, ql_e, qr_e, qc_e, s1_e, s2_e, s3_e, l1_e,
     zh_inv_e) = st["circ_e"].unbind(0)
    pts = prims.perm4n(tabs["coset_pts"])
    bpts = Fr.mont_mul(beta, pts)

    ab, a_ql, b_qr, c_qo, k1b, k2b, bs1, bs2, bs3, az, azw = Fr.mul_many([
        (a_e, b_e), (a_e, ql_e), (b_e, qr_e), (c_e, qo_e),
        (Fr.const(ctx.k1), bpts), (Fr.const(ctx.k2), bpts),
        (beta, s1_e), (beta, s2_e), (beta, s3_e), (alpha, z_e),
        (alpha, zw_e)])
    t1 = Fr.add(Fr.add(Fr.mont_mul(ab, qm_e), Fr.add(a_ql, pi_e)),
                Fr.add(b_qr, Fr.add(c_qo, qc_e)))
    lin = Fr.add(torch.stack([a_e, b_e, c_e, a_e, b_e, c_e]),
                 Fr.add(torch.stack([bpts, k1b, k2b, bs1, bs2, bs3]), gamma))
    pair = Fr.mont_mul(lin[[0, 3]], lin[[1, 4]])
    trip = Fr.mont_mul(pair, lin[[2, 5]])
    t2, t3 = Fr.mont_mul(trip, torch.stack([az, azw])).unbind(0)
    alpha_sq = Fr.mont_mul(alpha, alpha)
    t4 = Fr.mont_mul(Fr.mont_mul(Fr.sub(z_e, Fr.const(1)), alpha_sq), l1_e)
    t_num_e = Fr.add(Fr.sub(Fr.add(t1, t2), t3), t4)
    t_e = Fr.mont_mul(t_num_e, zh_inv_e)
    t_full = Fr.mont_mul(prims.intt4n(Fr, t_e), tabs["inv_shift_pows"])
    t_len = 3 * n + 6
    t_x = t_full[..., :t_len, :]
    part = n + 2
    return dict(z_omega_x=z_omega_x, l_1_x=st["l_1_x"], t_x=t_x,
                t_tail_zero=(t_full[..., t_len:, :] == 0).flatten(-2).all(-1),
                t_lo_x=t_x[..., :part, :],
                t_mid_x=t_x[..., part:2 * part, :],
                t_hi_x=t_x[..., 2 * part:, :])


def _stage_openings(ctx: BN254Context, st, q3, z_x, alpha, beta, gamma, z,
                    v):
    """Rounds 4 and 5: evaluations at z, linearization, opening quotients;
    the challenges are per-lane scalars (..., 16)."""
    Fr = ctx.Fr
    n = ctx.n
    k1c, k2c = Fr.const(ctx.k1), Fr.const(ctx.k2)
    alpha_sq = Fr.mont_mul(alpha, alpha)
    a_x, b_x, c_x = st["a_x"], st["b_x"], st["c_x"]
    peval = lambda c: BPol.peval(Fr, c, z)
    a_z, b_z, c_z = peval(a_x), peval(b_x), peval(c_x)
    s_sigma_1_z = peval(st["s_sigma_1"])
    s_sigma_2_z = peval(st["s_sigma_2"])
    t_z = peval(q3["t_x"])
    z_omega_z = peval(q3["z_omega_x"])

    r_x = BPol.pscale(Fr, st["q_m_x"], Fr.mont_mul(a_z, b_z))
    r_x = BPol.padd(Fr, r_x, BPol.pscale(Fr, st["q_l_x"], a_z))
    r_x = BPol.padd(Fr, r_x, BPol.pscale(Fr, st["q_r_x"], b_z))
    r_x = BPol.padd(Fr, r_x, BPol.pscale(Fr, st["q_o_x"], c_z))
    r_x = BPol.padd(Fr, r_x, st["q_c_x"])
    bz = Fr.mont_mul(beta, z)
    azg = Fr.add(Fr.add(a_z, bz), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mont_mul(k1c, bz)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mont_mul(k2c, bz)), gamma)
    r_x = BPol.padd(Fr, r_x, BPol.pscale(
        Fr, z_x, Fr.mont_mul(Fr.mont_mul(Fr.mont_mul(azg, bzg), czg),
                             alpha)))
    as1z = Fr.add(a_z, Fr.add(Fr.mont_mul(beta, s_sigma_1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mont_mul(beta, s_sigma_2_z), gamma))
    r_x = BPol.psub(Fr, r_x, BPol.pscale(
        Fr, st["s_sigma_3"],
        Fr.mont_mul(Fr.mont_mul(Fr.mont_mul(as1z, bs2z), alpha),
                    Fr.mont_mul(beta, z_omega_z))))
    l_1_z = peval(q3["l_1_x"])
    r_x = BPol.padd(Fr, r_x, BPol.pscale(Fr, z_x,
                                         Fr.mont_mul(l_1_z, alpha_sq)))
    r_z = BPol.peval(Fr, r_x, z)

    z_pow_part = Fr.pow_static(z, n + 2)
    z_pow_2part = Fr.mont_mul(z_pow_part, z_pow_part)
    w = BPol.padd(Fr, q3["t_lo_x"],
                  BPol.pscale(Fr, q3["t_mid_x"], z_pow_part))
    w = BPol.padd(Fr, w, BPol.pscale(Fr, q3["t_hi_x"], z_pow_2part))
    w = BPol.padd_const(Fr, w, Fr.neg(t_z))
    vpow = [None, v]
    for _ in range(5):
        vpow.append(Fr.mont_mul(vpow[-1], v))
    for k, (poly, ev) in enumerate(
            ((r_x, r_z), (a_x, a_z), (b_x, b_z), (c_x, c_z),
             (st["s_sigma_1"], s_sigma_1_z),
             (st["s_sigma_2"], s_sigma_2_z)), start=1):
        shifted = BPol.padd_const(Fr, poly, Fr.neg(ev))
        w = BPol.padd(Fr, w, BPol.pscale(Fr, shifted, vpow[k]))

    w_z_x_quo, rem1 = BPol.divide_by_linear(Fr, w, z)
    z_shift = BPol.padd_const(Fr, z_x, Fr.neg(z_omega_z))
    zw = Fr.mont_mul(z, Fr.const(ctx.omega))
    w_z_omega_x, rem2 = BPol.divide_by_linear(Fr, z_shift, zw)
    return dict(a_z=a_z, b_z=b_z, c_z=c_z, s_sigma_1_z=s_sigma_1_z,
                s_sigma_2_z=s_sigma_2_z, r_z=r_z, z_omega_z=z_omega_z,
                w_z_x_quo=w_z_x_quo, w_z_omega_x=w_z_omega_x,
                rem1=(rem1 == 0).all(-1), rem2=(rem2 == 0).all(-1))


def prove_bn254(ctx: BN254Context, selectors, copies, a_w, b_w, c_w,
                challenge, rand9, public_inputs=None,
                prims: BN254Prims | None = None, pre: dict | None = None
                ) -> tuple[BN254Proof, BN254Diagnostics]:
    """BN254 5-round prover. Inputs in STANDARD form as 16-bit-word
    arrays: selectors (5, n, 16), copies (3, n, 2), witness columns
    (n, 16), challenge (5, 16) [alpha beta gamma z v], rand9 (9, 16). With
    a leading batch axis (witness columns (B, n, 16), challenge (B, 5, 16),
    rand9 (B, 9, 16), public inputs (B, n, 16)) it gives B proofs in
    stack_proofs' layout and (B,) diagnostics, lane i equal to the proof
    of lane i's inputs.
    `pre` takes precompute_bn254's output; when None the same tables are
    computed inline (identical proof either way)."""
    Fr, Fq = ctx.Fr, ctx.Fq
    ch = Fr.encode(_as_words(challenge, ctx.device))
    alpha, beta, gamma, z, v = ch.unbind(-2)
    prims = prims or _local_prims(ctx)
    if pre is None:
        pre = precompute_bn254(ctx, selectors, copies, prims)
    st = _stage_prep(ctx, a_w, b_w, c_w, rand9, prims, pre, public_inputs)
    z_x, _ = _stage_grand_product(ctx, st, beta, gamma, prims)
    q3 = _stage_quotient(ctx, st, z_x, alpha, beta, gamma, prims)
    q5 = _stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, z, v)
    cms = prims.commit_many([st["a_x"], st["b_x"], st["c_x"], z_x,
                             q3["t_lo_x"], q3["t_mid_x"], q3["t_hi_x"],
                             q5["w_z_x_quo"], q5["w_z_omega_x"]])
    xs, ys = Fq.decode(cms.x), Fq.decode(cms.y)
    pick = lambda i: BigG1Affine(xs[..., i, :], ys[..., i, :],
                                 cms.inf[..., i])
    scal = Fr.decode(torch.stack([q5[k] for k in SCALAR_FIELDS]))
    proof = BN254Proof(*[pick(i) for i in range(9)], *scal.unbind(0))
    diags = BN254Diagnostics(satisfied=st["satisfied"],
                             t_tail_zero=q3["t_tail_zero"],
                             w_z_rem_zero=q5["rem1"],
                             w_zw_rem_zero=q5["rem2"])
    return proof, diags


def make_prover_bn254(ctx: BN254Context, selectors, copies,
                      prims: BN254Prims | None = None):
    """Prover for a fixed circuit: the circuit tables (and, with the
    default prims, the window table) are made once here; returns
    fn(a_w, b_w, c_w, challenge, rand9, public_inputs=None)
    -> (BN254Proof, BN254Diagnostics). `prims` defaults to _local_prims
    (the window table, made here, when use_bn254_fixed_base says so; else
    _commit_many); explicit prims are used as given."""
    if prims is None:
        prims = _local_prims(ctx)
        if use_bn254_fixed_base(ctx.device):
            bn254_fixed_base_table(ctx)
    pre = precompute_bn254(ctx, selectors, copies, prims)

    def fn(a_w, b_w, c_w, ch, rnd, public_inputs=None):
        return prove_bn254(ctx, selectors, copies, a_w, b_w, c_w, ch, rnd,
                           public_inputs=public_inputs, prims=prims, pre=pre)

    return fn


# ---------------- verifier ----------------

class BN254VK(NamedTuple):
    q_m_s: BigG1Affine
    q_l_s: BigG1Affine
    q_r_s: BigG1Affine
    q_o_s: BigG1Affine
    q_c_s: BigG1Affine
    s1_s: BigG1Affine
    s2_s: BigG1Affine
    s3_s: BigG1Affine


def make_vk_bn254(ctx: BN254Context, selectors, copies,
                  prims: BN254Prims | None = None) -> BN254VK:
    """Selector and permutation commitments (standard-form affine words),
    interpolated and committed by `prims` (default _local_prims, whose
    route use_bn254_fixed_base decides); the JAX package commits them by
    GLV Pippenger whatever the switch, which gives the same points."""
    Fr, Fq = ctx.Fr, ctx.Fq
    prims = prims or _local_prims(ctx)
    sel = Fr.encode(_as_words(selectors, ctx.device))
    sig = _sigma_values(ctx, copies)
    stacked = torch.stack([sel[3], sel[0], sel[1], sel[2], sel[4],
                           sig[0], sig[1], sig[2]])
    polys = prims.intt_n(Fr, stacked)
    cms = prims.commit_many([polys[i] for i in range(8)])
    xs, ys = Fq.decode(cms.x), Fq.decode(cms.y)
    return BN254VK(*[BigG1Affine(xs[i], ys[i], cms.inf[i])
                     for i in range(8)])


def _aff_to_jac(Fq, p: BigG1Affine) -> BigG1J:
    """Standard-form affine -> Jacobian (Montgomery)."""
    return affine_to_jac(Fq, Fq.encode(p.x), Fq.encode(p.y), p.inf)


def _std_bits(words: torch.Tensor, nbits: int = FR_BITS) -> torch.Tensor:
    """(..., n_words) standard 16-bit words -> (..., nbits) bits."""
    idx = torch.arange(nbits, device=words.device)
    return (words[..., idx // 16] >> (idx % 16)) & 1


def _verify_points(ctx: BN254Context, vk: BN254VK, proof: BN254Proof,
                   challenge, public_inputs=None):
    """Scalar and G1 reduction of the two KZG checks -> the four pairing
    lane points (W_z, -R_1, W_zw, -R_2), all Jacobian. The proof's leaves
    and the (..., 5, 16) challenge may carry leading batch axes (the
    points then carry them too); the verifying key and the (n, 16) public
    inputs are shared by every lane."""
    Fr, Fq = ctx.Fr, ctx.Fq
    n = ctx.n
    dev = ctx.device
    tabs = _tables(ctx)
    ch = Fr.encode(_as_words(challenge, dev))
    alpha, beta, gamma, z, v = ch.unbind(-2)
    batch = z.shape[:-1]
    k1c, k2c = Fr.const(ctx.k1), Fr.const(ctx.k2)
    a_z, b_z, c_z, s1_z, s2_z, r_z, zw_z = Fr.encode(torch.stack(
        [getattr(proof, f) for f in SCALAR_FIELDS])).unbind(0)
    alpha_sq = Fr.mont_mul(alpha, alpha)

    z_h_z = Fr.sub(Fr.pow_static(z, n), Fr.const(1))
    n_inv = tabs["n_inv"]
    l_1_z = Fr.mont_mul(Fr.mont_mul(z_h_z, n_inv),
                        Fr.inv(Fr.sub(z, Fr.const(1))))
    as1z = Fr.add(a_z, Fr.add(Fr.mont_mul(beta, s1_z), gamma))
    bs2z = Fr.add(b_z, Fr.add(Fr.mont_mul(beta, s2_z), gamma))
    r0 = Fr.add(
        Fr.mont_mul(Fr.mont_mul(Fr.mont_mul(alpha, Fr.mont_mul(as1z, bs2z)),
                                Fr.add(c_z, gamma)), zw_z),
        Fr.mont_mul(alpha_sq, l_1_z))
    t_z_num = Fr.sub(r_z, r0)
    if public_inputs is not None:
        pi_v = Fr.encode(_as_words(public_inputs, dev))
        h = tabs["h"]
        terms = Fr.mont_mul(Fr.mont_mul(pi_v, h),
                            Fr.inv(Fr.sub(z[..., None, :], h)))
        t_z_num = Fr.add(t_z_num, Fr.mont_mul(Fr.mont_mul(z_h_z, n_inv),
                                              BPol.tree_sum(Fr, terms)))
    t_z = Fr.mont_mul(t_z_num, Fr.inv(z_h_z))

    bz = Fr.mont_mul(beta, z)
    azg = Fr.add(Fr.add(a_z, bz), gamma)
    bzg = Fr.add(Fr.add(b_z, Fr.mont_mul(k1c, bz)), gamma)
    czg = Fr.add(Fr.add(c_z, Fr.mont_mul(k2c, bz)), gamma)
    z_coef = Fr.add(
        Fr.mont_mul(Fr.mont_mul(Fr.mont_mul(azg, bzg), czg), alpha),
        Fr.mont_mul(alpha_sq, l_1_z))
    s3_coef = Fr.mont_mul(Fr.mont_mul(Fr.mont_mul(as1z, bs2z), alpha),
                          Fr.mont_mul(beta, zw_z))
    vp = [None, v]
    for _ in range(5):
        vp.append(Fr.mont_mul(vp[-1], v))
    zpp = Fr.pow_static(z, n + 2)
    e_scalar = t_z
    for coef, val in ((vp[1], r_z), (vp[2], a_z), (vp[3], b_z),
                      (vp[4], c_z), (vp[5], s1_z), (vp[6], s2_z)):
        e_scalar = Fr.add(e_scalar, Fr.mont_mul(coef, val))
    g = bn254_generator(Fq, batch, dev)
    zw_mont = Fr.mont_mul(z, Fr.const(ctx.omega))

    # one batched double-and-add ladder for all 18 scalar products of
    # every lane (point negations folded into scalar negations mod r)
    jac = lambda a: BigG1J(*(c.expand(batch + (Fq.limbs,))
                             for c in _aff_to_jac(Fq, a)))
    mv = lambda s_: Fr.mont_mul(vp[1], s_)
    pairs = [
        (jac(proof.t_mid_s), zpp),
        (jac(proof.t_hi_s), Fr.mont_mul(zpp, zpp)),
        (jac(vk.q_m_s), mv(Fr.mont_mul(a_z, b_z))),
        (jac(vk.q_l_s), mv(a_z)),
        (jac(vk.q_r_s), mv(b_z)),
        (jac(vk.q_o_s), mv(c_z)),
        (jac(vk.q_c_s), vp[1]),
        (jac(proof.z_s), mv(z_coef)),
        (jac(vk.s3_s), Fr.neg(mv(s3_coef))),
        (jac(proof.a_s), vp[2]),
        (jac(proof.b_s), vp[3]),
        (jac(proof.c_s), vp[4]),
        (jac(vk.s1_s), vp[5]),
        (jac(vk.s2_s), vp[6]),
        (g, Fr.neg(e_scalar)),
        (jac(proof.w_z_s), z),
        (jac(proof.w_z_omega_s), zw_mont),
        (g, Fr.neg(zw_z)),
    ]
    pts = BigG1J(*(torch.stack([p[k] for p, _ in pairs]) for k in range(3)))
    scalars_std = Fr.decode(torch.stack([s for _, s in pairs]))
    out = big_jac_mul(Fq, pts, _std_bits(scalars_std), FR_BITS)
    lane = lambda i: BigG1J(out.X[i], out.Y[i], out.Z[i])
    r1 = jac(proof.t_lo_s)
    for i in range(16):
        r1 = big_jac_add(Fq, r1, lane(i))
    r2 = big_jac_add(Fq, jac(proof.z_s), big_jac_add(Fq, lane(16),
                                                       lane(17)))
    neg = lambda p: BigG1J(p.X, Fq.neg(p.Y), p.Z)
    return jac(proof.w_z_s), neg(r1), jac(proof.w_z_omega_s), neg(r2)


def _pairing_ratio_flags(ctx: BN254Context, w1, nr1, w2, nr2):
    """Second verify stage: one Miller loop over the 4B lanes, laid out as
    the JAX package lays them, [w1_*, nr1_*, w2_*, nr2_*] (B = 1 for
    points without a batch axis, (B,) with one), and one batched final
    exponentiation of the 2B ratios -> (ok1, ok2) bool tensors of the
    points' batch shape."""
    Fp = BPair.pairing_field()
    srs = ctx.srs
    batch = w1.X.shape[:-1]
    B = w1.X[..., 0].numel()
    lanes = BigG1J(*(torch.stack([p[k].reshape(B, Fp.limbs)
                                  for p in (w1, nr1, w2, nr2)]
                                 ).reshape(4 * B, Fp.limbs)
                     for k in range(3)))
    qx = torch.stack([srs.g2_sx, srs.g2_1x, srs.g2_sx, srs.g2_1x]
                     ).repeat_interleave(B, 0)
    qy = torch.stack([srs.g2_sy, srs.g2_1y, srs.g2_sy, srs.g2_1y]
                     ).repeat_interleave(B, 0)
    px, py, pinf = big_to_affine(Fp, lanes)
    ml = BPair.miller_loop(Fp, px, py, qx, qy)
    ml = torch.where(pinf[:, None, None, None, None],
                     f12_one(Fp, (4 * B,), px.device), ml)
    ratios = f12_mul(Fp, torch.cat([ml[:B], ml[2 * B:3 * B]]),
                     torch.cat([ml[B:2 * B], ml[3 * B:]]))
    outs = BPair.final_exponentiation(Fp, ratios)
    ok = f12_eq(Fp, outs, f12_one(Fp, (2 * B,), px.device))
    return ok[:B].reshape(batch), ok[B:].reshape(batch)


def verify_bn254(ctx: BN254Context, vk: BN254VK, proof: BN254Proof,
                 challenge, public_inputs=None) -> bool:
    """KZG verification with real BN254 pairings: the two checks
    e(W, [tau]_2) == e(R, [1]_2) as one batched Miller loop over four
    lanes and one shared final exponentiation."""
    pts = _verify_points(ctx, vk, proof, challenge, public_inputs)
    ok1, ok2 = _pairing_ratio_flags(ctx, *pts)
    return bool(ok1) and bool(ok2)


def verify_bn254_many(ctx: BN254Context, vk: BN254VK, proofs: BN254Proof,
                      challenges, public_inputs=None) -> torch.Tensor:
    """Batched verification: every BN254Proof leaf carries a leading batch
    axis B, `challenges` is (B, 5, 16), and one (n, 16) `public_inputs`
    (or None) is shared by every lane, as in the JAX package. The scalar
    and G1 algebra of all lanes runs as one ladder over the B x 18 points,
    the 4B Miller loops as one, and the 2B ratios share one final
    exponentiation. Returns a (B,) bool tensor whose lane i is
    verify_bn254 of proof i."""
    pts = _verify_points(ctx, vk, proofs, challenges, public_inputs)
    ok1, ok2 = _pairing_ratio_flags(ctx, *pts)
    return ok1 & ok2


def stack_proofs(proofs) -> BN254Proof:
    """Proofs stacked along a new leading batch axis (verify_bn254_many's
    input)."""
    return BN254Proof(*(
        BigG1Affine(*(torch.stack([f[k] for f in fields]) for k in range(3)))
        if isinstance(fields[0], BigG1Affine) else torch.stack(fields)
        for fields in zip(*proofs)))
