"""The sharded prefix product of the port (plonk_tpu_torch.parallel.dist_scan)
against the JAX package's dist_prefix_prod and dist_grand_product, on the
conftest's 8 CPU devices under both of JAX's CPU exchanges (lax.all_gather
and the Pallas ring kernel on the TPU interpret machine); and a PyTorch
model of the schedule of K8's prefix-scan kernel (csrc/collectives.cu
prefix_scan_kernel: the ticket order, each block's tile scan, the published
totals, the look-back, the gathered totals, the shifted form and the state
left for the next launch) against the plain version and JAX. Exact
equality; the port's shards all live on the CPU."""
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plonk_tpu.ops.field import MontField as JMontField
from plonk_tpu.parallel import dist_scan as JDS
from plonk_tpu.parallel import mesh as JMS
from plonk_tpu.utils.params import SCALED_FR
from plonk_tpu_torch.models.synthetic import edge_scan_words
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.parallel import collectives as CL
from plonk_tpu_torch.parallel import dist_scan as DS
from plonk_tpu_torch.parallel import mesh as MS

F, J = MontField(SCALED_FR), JMontField(SCALED_FR)
ONE = F.r_mod_p                           # the Montgomery one
SHAPES = [(D, m) for D in (1, 2, 8) for m in (1, 8, 4096)]


def _words(rng, D: int, m: int) -> np.ndarray:
    return rng.integers(0, F.p, size=D * m).astype(np.int64)


def _shards(x: np.ndarray, D: int) -> list:
    return [torch.as_tensor(c) for c in np.split(x, D)]


def _jax(fn, x: np.ndarray, D: int, exchange: str) -> np.ndarray:
    assert jax.device_count() >= 8, "conftest must provide 8 cpu devices"
    jmesh = JMS.make_1d_mesh("sp", D)
    out = fn(J, jmesh, jnp.asarray(x.astype(np.uint32)), "sp",
             exchange=exchange)
    return np.asarray(out, np.int64)


def _joined(shards) -> np.ndarray:
    return MS.unshard_vector(list(shards)).numpy()


# ---- the plain path against JAX ----

@pytest.mark.parametrize("D,m", SHAPES)
def test_plain_scan_matches_jax(D, m):
    """dist_prefix_prod and dist_grand_product on CPU shards (the plain
    path) equal JAX's under exchange "xla" and "pallas_sim"; the gathered
    totals are each shard's last scanned word over the carries, in shard
    order."""
    rng = np.random.default_rng(D * 100 + m)
    x = _words(rng, D, m)
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    scan, totals = DS.dist_scan(F, mesh, _shards(x, D))
    acc = DS.dist_grand_product(F, mesh, _shards(x, D))
    for exchange in ("xla", "pallas_sim"):
        np.testing.assert_array_equal(
            _joined(scan), _jax(JDS.dist_prefix_prod, x, D, exchange))
        np.testing.assert_array_equal(
            _joined(acc), _jax(JDS.dist_grand_product, x, D, exchange))
    np.testing.assert_array_equal(
        _joined(DS.dist_prefix_prod(F, mesh, _shards(x, D),
                                    exchange="plain")), _joined(scan))
    local = [DS._prefix_prod(F, s)[-1] for s in _shards(x, D)]
    for row in totals:
        assert row.tolist() == [int(t) for t in local]


# ---- a model of the kernel's schedule ----
# csrc/collectives.cu prefix_scan_kernel as a PyTorch program: each block a
# generator that yields at every access to the shared state, run in a
# random interleaving after a random start order; its tile scan with the
# kernel's thread, warp and lane index maps.

# The geometry and the flag layout are csrc/collectives.cu's SCAN_THREADS,
# SCAN_ITEMS, FLAG_AGGREGATE, FLAG_PREFIX, TICKET_BITS and EPOCH_SHIFT.
THREADS, ITEMS = 512, 16
TILE, WARPS = THREADS * ITEMS, THREADS // 32
AGGREGATE, PREFIX = 1 << 31, 2 << 31     # a flag's kind, bits 31-32
TICKET_BITS, EPOCH_SHIFT = 8, 33
T = torch.arange(THREADS)[:, None]
K = torch.arange(ITEMS)[None, :]
OWN = T * ITEMS + K                 # a thread's words in the tile
STRIPED = K * THREADS + T           # the coalesced load and store


def _padded(i: torch.Tensor) -> torch.Tensor:
    return i + (i >> 5)


def _shfl_up(x: torch.Tensor, off: int) -> torch.Tensor:
    """__shfl_up_sync over warps of 32 consecutive entries: lane l reads
    lane l - off; lanes below off read their own value."""
    w = x.reshape(-1, 32)
    return torch.cat([w[:, :off], w[:, :-off]], dim=1).reshape(x.shape)


def _warp_scan(x: torch.Tensor, width: int = 32) -> torch.Tensor:
    """The shuffle scan of warps of 32 lanes over the offsets below
    `width`."""
    lane = torch.arange(x.shape[0]) % 32
    for off in (1, 2, 4, 8, 16):
        if off < width:
            x = torch.where(lane >= off, F.mul(_shfl_up(x, off), x), x)
    return x


def _scan_tile(src: torch.Tensor, base: int, m: int):
    """scan_tile: (v (THREADS, ITEMS), excl (THREADS,), the tile's
    product), the words loaded striped into the padded shared tile and
    read back a thread's ITEMS at a time."""
    tile = torch.full((TILE + TILE // 32,), -1, dtype=torch.int64)
    g = base + STRIPED
    tile[_padded(STRIPED)] = torch.where(g < m, src[g.clamp(max=m - 1)],
                                         ONE)
    v = tile[_padded(OWN)]
    assert bool((v >= 0).all())
    cols = [v[:, 0]]
    for k in range(1, ITEMS):
        cols.append(F.mul(cols[-1], v[:, k]))
    v = torch.stack(cols, dim=1)
    x = _warp_scan(v[:, -1])
    lane = torch.arange(THREADS) % 32
    lane_excl = torch.where(lane == 0, ONE, _shfl_up(x, 1))
    # warp 0 scans the WARPS warp totals, its other lanes holding the one
    warp_tot = _warp_scan(torch.cat([x.reshape(WARPS, 32)[:, 31],
                                     torch.full((32 - WARPS,), ONE)]),
                          WARPS)[:WARPS]
    w = torch.arange(THREADS) // 32
    warp_excl = warp_tot[(w - 1).clamp(min=0)]
    excl = torch.where(w > 0, F.mul(warp_excl, lane_excl), lane_excl)
    return v, excl, int(warp_tot[-1])


def _store_tile(dst, hits, base, m, v, pre, shifted):
    tile = torch.full((TILE + TILE // 32,), -1, dtype=torch.int64)
    pre = pre[:, None]
    if shifted:
        tile[_padded(OWN)] = torch.cat([pre, F.mul(pre, v[:, :-1])], dim=1)
    else:
        tile[_padded(OWN)] = F.mul(pre, v)
    g = base + STRIPED
    live = g < m
    dst[g[live]] = tile[_padded(STRIPED)][live]
    hits.index_add_(0, g[live], torch.ones_like(g[live]))


def _cu_constants() -> dict:
    """The integer constexprs of csrc/collectives.cu, by name."""
    src = (Path(CL.__file__).parent.parent / "csrc" / "collectives.cu"
           ).read_text()
    found = re.findall(r"constexpr [\w ]+? (\w+) = ([0-9]+)(?:ull)?"
                       r"(?: << ([0-9]+))?;", src)
    return {name: int(v) << int(shift or 0) for name, v, shift in found}


def test_scan_model_constants_match_the_kernel_source():
    """The model's geometry and flag layout, and the wrapper's state size
    and shard limit, are the kernel's: a change to one copy fails here."""
    cu = _cu_constants()
    assert (cu["SCAN_THREADS"], cu["SCAN_ITEMS"]) == (THREADS, ITEMS)
    assert (cu["FLAG_AGGREGATE"], cu["FLAG_PREFIX"]) == (AGGREGATE, PREFIX)
    assert (cu["TICKET_BITS"], cu["EPOCH_SHIFT"]) == (TICKET_BITS,
                                                      EPOCH_SHIFT)
    assert cu["MAX_SHARDS"] == CL.MAX_SHARDS
    assert CL.SCAN_STATE_WORDS == 1 + cu["MAX_SHARDS"]
    assert cu["kBatch"] == CL.A2A_BATCH


def test_scan_tile_banks():
    """The padded tile puts a warp's 32 words in 32 banks both ways: a
    thread's ITEMS consecutive words, and the striped load and store."""
    for idx in (OWN, STRIPED):
        banks = _padded(idx).reshape(WARPS, 32, ITEMS) % 32
        for k in range(ITEMS):
            assert all(len(set(b[:, k].tolist())) == 32 for b in banks)


def _block(srcs, dsts, hits, totals, state, m, shifted, rng):
    """One block of prefix_scan_kernel; yields after each access to the
    state buffer (the ticket, the flags). Warp 0's lanes read the
    predecessors' flags in a random order, each when it holds this
    epoch's value."""
    D = len(srcs)
    t = state[0]
    state[0] += 1
    d, epoch = t % (1 << TICKET_BITS), t >> TICKET_BITS
    if d == D - 1:
        state[0] += (1 << TICKET_BITS) - D
    yield
    tag = (epoch % (1 << 31)) << EPOCH_SHIFT
    src = srcs[d]
    v, excl, first = _scan_tile(src, 0, m)
    total = first
    for base in range(TILE, m, TILE):
        total = int(F.mul(torch.tensor(total), _scan_tile(src, base, m)[2]))
    flags = 1
    state[flags + d] = tag | (AGGREGATE if d else PREFIX) | total
    yield
    for e in range(D):
        totals[e][d] = total
    fl = [0] * 32                    # lane l: shard d - 1 - l's flag
    for lane in rng.permutation(d):
        while (state[flags + d - 1 - lane] >> EPOCH_SHIFT != tag
               >> EPOCH_SHIFT or not state[flags + d - 1 - lane]
               & (AGGREGATE | PREFIX)):
            yield
        fl[lane] = state[flags + d - 1 - lane]
        yield
    prefixes = [lane for lane in range(32) if fl[lane] & PREFIX]
    stop = min(prefixes) if prefixes else -1
    carry = torch.tensor([f % (1 << 31) if lane <= stop else ONE
                          for lane, f in enumerate(fl)])
    for off in (16, 8, 4, 2, 1):
        carry = F.mul(carry, carry[torch.arange(32) ^ off])
    assert len(set(carry.tolist())) == 1
    carry = int(carry[0])
    if d:
        state[flags + d] = tag | PREFIX | int(F.mul(torch.tensor(carry),
                                                    torch.tensor(total)))
        yield
    run, tile_total = torch.tensor(carry), first
    for base in range(0, m, TILE):
        if base:
            v, excl, tile_total = _scan_tile(src, base, m)
        _store_tile(dsts[d], hits[d], base, m, v, F.mul(run, excl), shifted)
        run = F.mul(run, torch.tensor(tile_total))


def _k8_model(shards, shifted: bool, state: list, seed: int):
    """prefix_scan as the kernel computes it, its D blocks started and
    interleaved at random; asserts every output word is written exactly
    once. Returns (outputs, gathered totals)."""
    D, m = len(shards), shards[0].shape[0]
    rng = np.random.default_rng(seed)
    dsts = [torch.full((m,), -1, dtype=torch.int64) for _ in range(D)]
    hits = [torch.zeros(m, dtype=torch.int64) for _ in range(D)]
    totals = [[-1] * D for _ in range(D)]
    running, pending = [], D
    while pending or running:
        # a block not yet started may start (and take its ticket), or a
        # running one makes its next step
        k = int(rng.integers(0, len(running) + (1 if pending else 0)))
        if k == len(running):
            running.append(_block(shards, dsts, hits, totals, state, m,
                                  shifted, rng))
            pending -= 1
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    assert all(bool((h == 1).all()) for h in hits)
    return dsts, [torch.tensor(row) for row in totals]


def _launches(state: list) -> int:
    """The epoch the ticket holds, after asserting that no block of a
    launch left a count behind."""
    assert state[0] % (1 << TICKET_BITS) == 0
    return state[0] >> TICKET_BITS


@pytest.mark.parametrize("D,m", SHAPES + [(2, 2 * TILE + 5)])
def test_scan_schedule_model_matches_plain_and_jax(D, m):
    """The model's scan and shifted form equal the plain path's and JAX's
    (lax.all_gather exchange), its gathered totals the plain all-gather's;
    two launches on one state buffer. A shard longer than a tile (8192
    words) is scanned twice by its block."""
    rng = np.random.default_rng(D + m)
    x = _words(rng, D, m)
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    state = [0] * CL.SCAN_STATE_WORDS
    for seed, shifted in ((D, False), (D + 1, True)):
        got, totals = _k8_model(_shards(x, D), shifted, state, seed)
        want, want_totals = DS.dist_scan_plain(F, mesh, _shards(x, D),
                                               shifted)
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        assert all(torch.equal(g, w) for g, w in zip(totals, want_totals,
                                                     strict=True))
        fn = JDS.dist_grand_product if shifted else JDS.dist_prefix_prod
        if m < TILE:
            np.testing.assert_array_equal(_joined(got),
                                          _jax(fn, x, D, "xla"))
    assert _launches(state) == 2


def test_scan_model_state_across_launches():
    """One state buffer through launches of 8, 3, 16, 1 and 8 shards, as a
    stream runs them with no reset between: each launch moves the ticket
    to the next epoch and waits only for its own epoch's flags, so the
    flags an earlier launch left (stale prefixes above D included) never
    pass; each scan equals the plain version's."""
    state = [0] * CL.SCAN_STATE_WORDS
    rng = np.random.default_rng(5)
    for k, D in enumerate((8, 3, 16, 1, 8)):
        x = _words(rng, D, 40)
        got, totals = _k8_model(_shards(x, D), k % 2 == 1, state, k)
        want, want_totals = DS.dist_scan_plain(
            F, MS.make_1d_mesh("sp", D, device="cpu"), _shards(x, D),
            k % 2 == 1)
        assert all(torch.equal(g, w) for g, w in zip(got + totals,
                                                     want + want_totals,
                                                     strict=True))
        assert _launches(state) == k + 1
        assert all(f >> EPOCH_SHIFT == k for f in state[1:1 + D])


@pytest.mark.parametrize("D,m", [(1, 8), (2, 1), (8, 8), (8, 4096)])
def test_scan_edge_words(D, m):
    """Words 0, p - 1 and the Montgomery one: model, plain path and JAX's
    ring-kernel exchange agree, and the zero in shard D // 2 zeroes every
    word of the later shards."""
    rng = np.random.default_rng(3 * D + m)
    x = edge_scan_words(F.p, D, m, rng)
    mesh = MS.make_1d_mesh("sp", D, device="cpu")
    for shifted, fn in ((False, JDS.dist_prefix_prod),
                        (True, JDS.dist_grand_product)):
        state = [0] * CL.SCAN_STATE_WORDS
        got, totals = _k8_model(_shards(x, D), shifted, state, m)
        want, want_totals = DS.dist_scan_plain(F, mesh, _shards(x, D),
                                               shifted)
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        assert all(torch.equal(g, w) for g, w in zip(totals, want_totals,
                                                     strict=True))
        np.testing.assert_array_equal(_joined(got),
                                      _jax(fn, x, D, "pallas_sim"))
        assert int(totals[0][D // 2]) == 0
        for d in range(D // 2 + 1, D):
            assert not bool(got[d].any())


def test_scan_refusals():
    """The kernel's wrapper refuses shards it does not take, before any
    launch; on CPU shards exchange="cuda" raises."""
    mesh = MS.make_1d_mesh("sp", 2, device="cpu")
    xs = [torch.ones(4, dtype=torch.int64)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        DS.dist_prefix_prod(F, mesh, xs, exchange="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        CL.prefix_scan(xs, F.p, F.n_prime, ONE)
    with pytest.raises(ValueError, match="1..16"):
        CL.prefix_scan([xs[0]] * 17, F.p, F.n_prime, ONE)
    with pytest.raises(ValueError, match="shards for a mesh"):
        DS.dist_grand_product(F, mesh, xs[:1])
