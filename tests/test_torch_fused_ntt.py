"""Parity of the port's fused four-step transforms
(plonk_tpu_torch.ops.fused_ntt) and of K5's plain version
(plonk_tpu_torch.ops.row_stages.row_transform_plain) with the JAX package:
its fused_ntt / fused_intt / fused_ntt_1k / fused_intt_1k and its Pallas
row_transform, run in interpret mode as tests/test_fused_ntt.py runs them.
Exact equality of words."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import fused_ntt as JFN
from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.ops.pallas_ntt import row_transform as j_row_transform
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops import fused_ntt as FN
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import MontField, add_mod, mont_mul, sub_mod
from plonk_tpu_torch.ops.row_stages import row_transform, row_transform_plain

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)


def _mont_words(seed, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return F.encode_host(rng.integers(0, F.p, size=shape))


def _jax(x: np.ndarray):
    return jnp.asarray(x.astype(np.uint32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("log_n", [6, 8, 10])
@pytest.mark.parametrize("onepass", [False, True], ids=["fused", "1k"])
def test_fused_transforms_match_jax(log_n, onepass):
    """Forward, inverse-root forward and inverse, on a batch of 3."""
    n = 1 << log_n
    w = SCALED_FR.root_of_unity(n)
    x = _mont_words(log_n, (3, n))
    fwd, inv = ((FN.fused_ntt_1k, FN.fused_intt_1k) if onepass
                else (FN.fused_ntt, FN.fused_intt))
    jfwd, jinv = ((JFN.fused_ntt_1k, JFN.fused_intt_1k) if onepass
                  else (JFN.fused_ntt, JFN.fused_intt))
    y = fwd(F, torch.as_tensor(x), w)
    _eq(y, jfwd(J, _jax(x), w, interpret=True))
    _eq(fwd(F, torch.as_tensor(x), w, inverse=True),
        jfwd(J, _jax(x), w, inverse=True, interpret=True))
    back = inv(F, y, w)
    _eq(back, jinv(J, _jax(y.numpy()), w, interpret=True))
    np.testing.assert_array_equal(back.numpy(), x)
    # scrambled layout: the natural transform through scrambled_perm
    nat = N.ntt(F, torch.as_tensor(x), w)
    np.testing.assert_array_equal(y.numpy(),
                                  nat.numpy()[:, FN.scrambled_perm(n)])


@pytest.mark.parametrize("R,C", [(8, 8), (16, 32), (4, 512)])
@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
def test_row_transform_plain_matches_pallas_interpret(R, C, dif):
    w = SCALED_FR.root_of_unity(C)
    tw = F.encode_host(np.stack(JN._stage_tables(F.p, w, C, C)))
    y = _mont_words(R + C, (R, C))
    want = j_row_transform(J.p, J.n_prime, _jax(y), _jax(tw), dif,
                           interpret=True)
    args = (F.p, F.n_prime, torch.as_tensor(y), torch.as_tensor(tw), dif)
    got = row_transform_plain(*args)
    _eq(got, want)
    # on a CPU tensor the wrapper is its plain version
    _eq(row_transform(*args), got.numpy())


def test_tables_and_layout_match_jax():
    n1, n2 = 16, 32
    w = SCALED_FR.root_of_unity(n1 * n2)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            FN._twiddle_matrix(F.p, w, n1, n2, inverse),
            JFN._twiddle_matrix(F.p, w, n1, n2, inverse).astype(np.int64))
    for n in (64, 512):
        np.testing.assert_array_equal(FN.scrambled_perm(n),
                                      JFN.scrambled_perm(n))


# ---- K6's packed tables and its register-round schedule, on the CPU ----
# csrc/onepass_ntt.cu cannot run here; these hold the index maps it is
# built from (tile positions, rounds, twiddle entries) against the plain
# version at small shapes, and its shared-memory swizzle at the path's
# 512 x 512 tiles.

def _k6_plan(S: int, cbits: int, column: bool):
    """onepass_ntt.cu pass_geom's rounds: (q bits of a tile, [(stage bits
    b, element bit glo of register 0, qoff[8], gpos)] by element-bit
    group, lowest first)."""
    eoff = cbits if column else 0
    wq = max(S + cbits, 3)
    nr = 1 if S == 0 else (S + 2) // 3
    b0 = 0 if S == 0 else S - 3 * (nr - 1)
    plans = []
    for grp in range(nr):
        b = b0 if grp == 0 else 3
        glo = 0 if grp == 0 else b0 + 3 * (grp - 1)
        stage = set(range(eoff + glo, eoff + glo + b))
        qpos = []
        for e in range(3):
            qpos.append(eoff + glo + e if e < b else min(
                x for x in range(32) if x not in stage and x not in qpos))
        used = set(qpos)
        qoff = [sum((k >> e & 1) << qpos[e] for e in range(3))
                for k in range(8)]
        gpos = []
        for r in range(5):
            for pos in (r, r + 5):
                if pos < min(wq, 10) and pos not in used:
                    gpos.append(pos)
                    used.add(pos)
                    break
        gpos += [pos for pos in range(wq) if pos not in used]
        plans.append((b, glo, qoff, gpos))
    return wq, plans


def _k6_axis_model(y, tw, S: int, cbits: int, column: bool, dif: bool,
                   twm=None, scale=None):
    """One pass of K6's schedule on y (nb, n1, n2): tiles of 2^cbits
    columns (or rows), register rounds of up to 3 stages on the positions
    of each group, twiddles from the powers in tw[S - 1]."""
    p, npr = F.p, F.n_prime
    nb, n1, n2 = y.shape
    flat = y.reshape(-1).clone()
    wq, plans = _k6_plan(S, cbits, column)
    rows = nb * n1
    if column:
        tiles = [(m * n1 * n2 + c0, n1 << cbits)
                 for m in range(nb) for c0 in range(0, n2, 1 << cbits)]
    else:
        tiles = [(r0 * n2, (min(rows - r0, 1 << cbits)) * n2)
                 for r0 in range(0, rows, 1 << cbits)]
    pw = tw[S - 1][: (1 << S) // 2] if S else tw
    order = range(len(plans) - 1, -1, -1) if dif else range(len(plans))
    groups = 1 << (wq - 3)

    def word(q):
        if not column:
            return q
        return (q >> cbits) * n2 + (q & ((1 << cbits) - 1))

    for origin, valid in tiles:
        seen = torch.zeros(1 << wq, dtype=torch.int64)
        for grp in order:
            b, glo, qoff, gpos = plans[grp]
            g = torch.arange(groups)
            base = sum((((g >> i) & 1) << pos for i, pos in enumerate(gpos)),
                       torch.zeros_like(g))
            q = base[:, None] | torch.tensor(qoff)[None, :]    # (groups, 8)
            seen.index_add_(0, q.reshape(-1), torch.ones(q.numel(),
                                                         dtype=torch.int64))
            ok = q < valid
            at = origin + word(q)
            v = torch.where(ok, flat[at.clamp(max=flat.numel() - 1)], 0)
            ebase = (base >> (cbits if column else 0)) & ((1 << S) - 1)
            for i in range(b):
                e = b - 1 - i if dif else i
                s = glo + e
                for k in range(8):
                    if k >> e & 1:
                        continue
                    h = k | 1 << e
                    j = ebase | ((k & ((1 << e) - 1)) << glo)
                    w = pw[((j & ((1 << s) - 1)) << (S - 1 - s))]
                    a, c = v[:, k], v[:, h]
                    if dif:
                        lo = add_mod(a, c, p)
                        hi = sub_mod(a, c, p)
                        hi = mont_mul(hi, w, p, npr) if s else hi
                    else:
                        u = mont_mul(c, w, p, npr) if s else c
                        lo, hi = add_mod(a, u, p), sub_mod(a, u, p)
                    v[:, k], v[:, h] = lo, hi
            flat[at[ok]] = v[ok]
        assert bool((seen == len(plans)).all())   # each round covers the tile
    out = flat.reshape(nb, n1, n2)
    if twm is not None:
        out = mont_mul(out, twm, p, npr)
    if scale is not None:
        out = mont_mul(out, scale, p, npr)
    return out


@pytest.mark.parametrize("nb,n", [(1, 2), (3, 4), (1, 64), (2, 1 << 11),
                                  (3, 1 << 10), (1, 1 << 14)])
@pytest.mark.parametrize("mirror", [False, True], ids=["fwd", "mirror"])
def test_onepass_schedule_model_matches_plain(nb, n, mirror):
    """K6's tiles (4 columns of n1 rows at n1 = 512; 2048 words), rounds
    and twiddle indices, run in PyTorch, equal onepass_plain."""
    w = SCALED_FR.root_of_unity(n)
    n1, n2 = FN._split(n)
    x = torch.as_tensor(_mont_words(n + nb, (nb, n1, n2)))
    tw1, twm, tw2 = FN.onepass_tables(F, w, n, mirror, "cpu")
    tw1, twm, tw2 = tw1.long(), twm.long(), tw2.long()
    S1, S2 = n1.bit_length() - 1, n2.bit_length() - 1
    c0 = (min(max(2048 // n1, 1), n2)).bit_length() - 1
    c1 = min(max(2048 // n2, 1),
             1 << (nb * n1 - 1).bit_length()).bit_length() - 1
    scale = F.const(pow(n, -1, F.p)) if mirror else None
    if not mirror:
        a = _k6_axis_model(x, tw1, S1, c0, True, True, twm=twm)
        got = _k6_axis_model(a, tw2, S2, c1, False, True)
    else:
        a = _k6_axis_model(x, tw2, S2, c1, False, False, twm=twm)
        got = _k6_axis_model(a, tw1, S1, c0, True, False, scale=scale)
    want = FN.onepass_plain(F.p, F.n_prime, x, tw1, twm, tw2, mirror, scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,cbits,column", [(9, 2, True), (9, 2, False),
                                            (13, 0, False), (11, 1, True)])
def test_onepass_rounds_hit_distinct_banks(S, cbits, column):
    """In every round a warp's 32 threads, for each register, address 32
    distinct banks of the swizzled tile (word q at q ^ (q >> 5) & 31)."""
    wq, plans = _k6_plan(S, cbits, column)
    for b, glo, qoff, gpos in plans:
        g = torch.arange(32)
        base = sum(((g >> i) & 1) << pos for i, pos in enumerate(gpos))
        for k in range(8):
            q = base | qoff[k]
            bank = (q ^ (q >> 5)) & 31
            assert len(set(bank.tolist())) == 32


@pytest.mark.parametrize("n", [2, 64, 1 << 18])
def test_onepass_tables_pack_the_int64_tables(n):
    """onepass_tables' int32 words are the int64 tables' words, and the
    last stage's first n/2 lanes hold every lane twiddle the kernel reads
    (stage s, lane j: entry (j mod 2^s) << (S - 1 - s))."""
    w = SCALED_FR.root_of_unity(n)
    n1, n2 = FN._split(n)
    packed = FN.onepass_tables(F, w, n, False, "cpu")
    want = (FN._row_tables(F, pow(w, n2, F.p), n1, "cpu"),
            FN._tw_mat(F, w, n1, n2, False, True, "cpu"),
            FN._row_tables(F, pow(w, n1, F.p), n2, "cpu"))
    for got, ref in zip(packed, want):
        assert got.dtype == torch.int32 and torch.equal(got.long(), ref)
    for tw in (want[0], want[2]):
        S, length = tw.shape
        j = torch.arange(length)
        for s in range(S):
            idx = (j & ((1 << s) - 1)) << (S - 1 - s)
            assert torch.equal(tw[s], tw[S - 1][idx])
