"""Parity of the port's NTT (plonk_tpu_torch.ops.ntt) and of K1's plain
version (plonk_tpu_torch.ops.row_stages) with the JAX package: the XLA
transforms of plonk_tpu.ops.ntt, and the Pallas row-stage kernel run in
interpret mode, as tests/test_pallas_ntt.py runs it; and a PyTorch model
of the schedule of csrc/row_stages.cu, K1's DIT stages and K5's DIF and
DIT full-row transforms, against both and against JAX's Pallas full-row
kernel. Exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops import ntt as JN
from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.ops.pallas_ntt import row_stages as j_row_stages
from plonk_tpu.ops.pallas_ntt import row_transform as j_row_transform
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.ops.row_stages import (compact_twiddles, row_stages,
                                            row_stages_plain,
                                            row_transform_plain)

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, F.p, size=shape).astype(np.int64)


@pytest.mark.parametrize("n,batch", [(16, ()), (16, (3,)), (4096, ()),
                                     (4096, (3,))])
def test_ntt_intt_match_jax(n, batch):
    rng = np.random.default_rng(n + len(batch))
    x = _words(rng, batch + (n,))
    w = SCALED_FR.root_of_unity(n)
    jx = jnp.asarray(x.astype(np.uint32))
    got = N.ntt(F, torch.as_tensor(x), w)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JN.ntt(J, jx, w), np.int64))
    back = N.intt(F, got, w)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        N.intt(F, torch.as_tensor(x), w).numpy(),
        np.asarray(JN.intt(J, jx, w), np.int64))


@pytest.mark.parametrize("R,C", [(16, 256), (8, 1024)])
def test_row_stages_plain_matches_pallas_interpret(R, C):
    n = R * C
    w = SCALED_FR.root_of_unity(n)
    tables = JN._stage_tables(F.p, w, n, C)
    n_intra = C.bit_length() - 1
    tw = F.encode_host(np.stack(tables[:n_intra]))
    y = F.encode_host(_words(np.random.default_rng(R), (R, C)))
    want = j_row_stages(J.p, J.n_prime, jnp.asarray(y.astype(np.uint32)),
                        jnp.asarray(tw.astype(np.uint32)), block_rows=8,
                        interpret=True)
    args = (F.p, F.n_prime, torch.as_tensor(y), torch.as_tensor(tw))
    got = row_stages_plain(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    # on a CPU tensor the wrapper is its plain version
    np.testing.assert_array_equal(row_stages(*args).numpy(), got.numpy())


def test_stage_tables_match_jax():
    n, C = 1 << 13, 1024
    w = SCALED_FR.root_of_unity(n)
    for got, want in zip(N._stage_tables(F.p, w, n, C),
                         JN._stage_tables(J.p, w, n, C)):
        np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(N._bit_reverse_perm(n),
                                  JN._bit_reverse_perm(n))


# csrc/row_stages.cu cannot run here; these hold the index maps it is built
# from (compact table, tile positions, rounds, twiddle entries) and its
# lazy residues in both directions against the plain versions and the
# Pallas kernels, and its shared-memory swizzle, at every row width.

_TILE_BITS = 11          # row_stages.cu kTileBits: 2048 words, 8 a thread


def _k1_plan(S: int):
    """row_stages.cu row_geom's rounds: [(stage bits b, element bit glo of
    register 0, qoff[8], gpos)], lowest element bits first."""
    nr = (S + 2) // 3
    b0 = S - 3 * (nr - 1)
    plans = []
    for grp in range(nr):
        b = b0 if grp == 0 else 3
        glo = 0 if grp == 0 else b0 + 3 * (grp - 1)
        stage = set(range(glo, glo + b))
        qpos = []
        for e in range(3):
            qpos.append(glo + e if e < b else min(
                x for x in range(32) if x not in stage and x not in qpos))
        used = set(qpos)
        qoff = [sum((k >> e & 1) << qpos[e] for e in range(3))
                for k in range(8)]
        gpos = []
        for r in range(5 if grp else 0):
            for pos in (r, r + 5):
                if pos not in used:
                    gpos.append(pos)
                    used.add(pos)
                    break
        gpos += [pos for pos in range(_TILE_BITS) if pos not in used]
        plans.append((b, glo, qoff, gpos))
    return plans


def _mul_lazy(a, b):
    """row_stages.cu mul_lazy: REDC(a * b) without its final subtraction,
    below 2p for a < 4p, b < p."""
    t = a * b
    lo = t & 0xFFFFFFFF
    m = (lo * (F.n_prime & 0xFFFF)
         + (((lo * (F.n_prime >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (t >> 32) + ((m * F.p) >> 32) + (lo != 0).long()


def _csub(a, m: int):
    return torch.where(a >= m, a - m, a)


def _k1_model(y: torch.Tensor, compact: torch.Tensor,
              dif: bool = False) -> torch.Tensor:
    """The kernel's schedule on y (R, C) in PyTorch: tiles of 2048 words,
    register rounds of up to 3 stages on each group's 8 positions, one lazy
    product a butterfly with its twiddle from the compact table, words
    below 2p between stages and canonical at the store. DIT (K1, K5's
    bit-reversed -> natural) runs the rounds from the lowest element bits
    up; DIF (K5's natural -> bit-reversed) the same rounds from the top
    down, each round's stages from its highest, with the Gentleman-Sande
    butterfly (a + b, (a - b + 2p) * tw)."""
    R, C = y.shape
    S = C.bit_length() - 1
    p2 = 2 * F.p
    flat = y.reshape(-1)
    out = torch.full_like(flat, -1)
    plans = _k1_plan(S)
    for origin in range(0, R * C, 1 << _TILE_BITS):
        valid = min(R * C - origin, 1 << _TILE_BITS)
        tile = torch.zeros(1 << _TILE_BITS, dtype=torch.int64)
        tile[:valid] = flat[origin:origin + valid]
        seen = torch.zeros_like(tile)
        for b, glo, qoff, gpos in (plans[::-1] if dif else plans):
            g = torch.arange(1 << (_TILE_BITS - 3))
            base = sum((((g >> i) & 1) << pos for i, pos in enumerate(gpos)),
                       torch.zeros_like(g))
            q = base[:, None] | torch.tensor(qoff)[None, :]    # (groups, 8)
            seen.index_add_(0, q.reshape(-1), torch.ones(q.numel(),
                                                         dtype=torch.int64))
            v = tile[q]
            ebase = base & (C - 1)
            for e in (reversed(range(b)) if dif else range(b)):
                s = glo + e
                mask = (1 << s) - 1
                for k in range(8):
                    if k >> e & 1:
                        continue
                    h = k | 1 << e
                    j = ebase | ((k & ((1 << e) - 1)) << glo)
                    w = compact[mask + (j & mask)]
                    if dif:
                        a, bv = v[:, k].clone(), v[:, h].clone()
                        v[:, k] = _csub(a + bv, p2)
                        v[:, h] = _mul_lazy(a - bv + p2, w)
                    else:
                        u = _mul_lazy(v[:, h], w)
                        v[:, h] = _csub(v[:, k] - u + p2, p2)
                        v[:, k] = _csub(v[:, k] + u, p2)
            assert int(v.max()) < p2
            tile[q] = v
        assert bool((seen == len(plans)).all())   # each round covers the tile
        out[origin:origin + valid] = _csub(tile[:valid], F.p)
    return out.reshape(R, C)


def _k1_table(C: int) -> torch.Tensor:
    """The intra-row stack ops/ntt.py gives K1 for an 8-row transform."""
    n = 8 * C
    tables = N._stage_tables(F.p, SCALED_FR.root_of_unity(n), n, C)
    return torch.as_tensor(F.encode_host(np.stack(
        tables[:C.bit_length() - 1])))


@pytest.mark.parametrize("C", [1 << s for s in range(1, 11)])
def test_row_stages_schedule_model_matches_plain_and_pallas(C):
    """K1's compact table and schedule, run in PyTorch on random and edge
    rows over two full tiles and a partial one, equal row_stages_plain,
    and row_stages_plain equals the Pallas kernel in interpret mode."""
    from plonk_tpu_torch.models.synthetic import edge_rows
    tw = _k1_table(C)
    compact = compact_twiddles(tw).long()
    S = C.bit_length() - 1
    assert compact.shape == (C - 1,)
    for s in range(S):
        assert torch.equal(compact[(1 << s) - 1:(1 << (s + 1)) - 1],
                           tw[s, :1 << s])
    rng = np.random.default_rng(C)
    R = 2 * (1 << _TILE_BITS) // C + 3
    y = torch.as_tensor(np.concatenate([
        rng.integers(0, F.p, size=(R // 2, C)),
        edge_rows(F.p, R - R // 2, C, rng)]))
    want = row_stages_plain(F.p, F.n_prime, y, tw)
    assert torch.equal(_k1_model(y, compact), want)
    jy = jnp.asarray(y[:8].numpy().astype(np.uint32))
    jwant = j_row_stages(J.p, J.n_prime, jy,
                         jnp.asarray(tw.numpy().astype(np.uint32)),
                         block_rows=8, interpret=True)
    np.testing.assert_array_equal(want[:8].numpy(),
                                  np.asarray(jwant, np.int64))


def _edge_rows(R: int, C: int, rng, half: int) -> torch.Tensor:
    from plonk_tpu_torch.models.synthetic import edge_rows
    return torch.as_tensor(np.concatenate([
        rng.integers(0, F.p, size=(R // 2, C)),
        edge_rows(F.p, R - R // 2, C, rng, half)]))


@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
@pytest.mark.parametrize("C", [1 << s for s in range(1, 11)])
def test_row_transform_schedule_model_matches_plain_and_pallas(C, dif):
    """K5: the kernel's schedule in each direction, run in PyTorch on random
    and edge rows (zeros, p - 1, first-stage partners with lo = hi and
    with hi = p - lo) over two full tiles and a partial one, equals
    row_transform_plain, which equals JAX's Pallas full-row kernel in
    interpret mode. The table is a full row transform's, as
    ops/fused_ntt.py makes it."""
    w = SCALED_FR.root_of_unity(C)
    tw = torch.as_tensor(F.encode_host(np.stack(
        N._stage_tables(F.p, w, C, C))))
    compact = compact_twiddles(tw).long()
    rng = np.random.default_rng(C + dif)
    R = 2 * (1 << _TILE_BITS) // C + 3
    y = _edge_rows(R, C, rng, C // 2 if dif else 1)
    want = row_transform_plain(F.p, F.n_prime, y, tw, dif)
    assert torch.equal(_k1_model(y, compact, dif), want)
    jwant = j_row_transform(J.p, J.n_prime,
                            jnp.asarray(y[:8].numpy().astype(np.uint32)),
                            jnp.asarray(tw.numpy().astype(np.uint32)), dif,
                            block_rows=8, interpret=True)
    np.testing.assert_array_equal(want[:8].numpy(),
                                  np.asarray(jwant, np.int64))


@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
@pytest.mark.parametrize("S", range(1, 11))
def test_row_stages_rounds_hit_distinct_banks(S, dif):
    """In every round, in the order each direction runs them, a warp's 32
    threads, for each register, address 32 distinct banks of the swizzled
    tile (word q at q ^ (q >> 5) & 31)."""
    plans = _k1_plan(S)
    for b, glo, qoff, gpos in (plans[::-1] if dif else plans):
        g = torch.arange(32)
        base = sum(((g >> i) & 1) << pos for i, pos in enumerate(gpos))
        for k in range(8):
            q = base | qoff[k]
            assert len(set(((q ^ (q >> 5)) & 31).tolist())) == 32


@pytest.mark.parametrize("S", range(1, 11))
def test_row_transform_dif_store_transposes_warp_tiles(S):
    """K5's DIF store: round 0 gives warp w the 256 positions from 256 w,
    8 neighbours a thread, which it writes to the swizzled tile and reads
    back as 4 rounds of 32 neighbour pairs (512 contiguous bytes a store),
    each of its accesses on 32 distinct banks."""
    b, glo, qoff, gpos = _k1_plan(S)[0]
    assert qoff == list(range(8)) and gpos == list(range(3, _TILE_BITS))
    swz = lambda q: (q ^ (q >> 5)) & 31                # noqa: E731
    lane = torch.arange(32)
    for w in range(8):
        base = (w << 8) | (lane << 3)
        assert sorted((base[:, None] | torch.arange(8)).reshape(-1)
                      .tolist()) == list(range(w << 8, (w + 1) << 8))
        for k in range(8):
            assert len(set(swz(base | k).tolist())) == 32
        got = []
        for j in range(4):
            q = (w << 8) | (j << 6) | (lane << 1)
            for h in (0, 1):
                assert len(set(swz(q + h).tolist())) == 32
            got += torch.stack([q, q + 1], 1).reshape(-1).tolist()
        assert got == list(range(w << 8, (w + 1) << 8))


def test_compact_twiddles_refuses_non_periodic_tables():
    """K1 shares one twiddle between a pair's lanes, so its wrapper refuses
    a table whose stage s is not periodic in 2^s, and caches the compact
    form of one it accepts."""
    tw = _k1_table(64)
    assert compact_twiddles(tw) is compact_twiddles(tw)
    bad = tw.clone()
    bad[3, 8 + 5] += 1                  # lane 13 of stage 3 differs from 5
    with pytest.raises(ValueError, match="stage 3"):
        compact_twiddles(bad)
