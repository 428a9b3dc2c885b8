"""Parity of the port's collectives and mesh (plonk_tpu_torch.parallel) with
the JAX package: K8's and K9's plain versions against the Pallas kernels
of plonk_tpu.parallel.pallas_collectives run on the TPU interpret machine
(`interpret_mode="sim"`) over the 8-device CPU mesh, and against the
concatenation semantics for D in {1, 2, 4, 8}; and a PyTorch model of
K9's index map (its host plan and its grid) against the plain version,
lax.all_to_all and the Pallas kernel. Exact equality; the port's shards
all live on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

from plonk_tpu.parallel import mesh as JMS
from plonk_tpu.parallel.pallas_collectives import (all_to_all_in_body,
                                                   ring_all_gather)
from plonk_tpu_torch.parallel import collectives as CL
from plonk_tpu_torch.parallel import mesh as MS


@pytest.fixture(scope="module")
def jmesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 cpu devices"
    return JMS.make_1d_mesh("sp", 8)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 31, size=shape).astype(np.int64)


def _shards(x: np.ndarray, D: int) -> list:
    """D shards of x along its first axis, as the JAX mesh splits P("sp")."""
    return [torch.as_tensor(c) for c in np.split(x, D, axis=0)]


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(6,), (3, 5), (1, 1)])
def test_all_gather_plain_concatenates(D, shape):
    rng = np.random.default_rng(D * 10 + len(shape))
    x = _words(rng, (D * shape[0],) + shape[1:])
    outs = CL.all_gather(_shards(x, D))
    assert len(outs) == D
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), x)
    # the plain exchange is the CPU default
    for out in CL.all_gather(_shards(x, D), exchange="plain"):
        np.testing.assert_array_equal(out.numpy(), x)


@pytest.mark.parametrize("shape", [(64,), (16, 20)])
def test_all_gather_matches_jax_ring_kernel(jmesh8, shape):
    """K8's function: JAX's remote-DMA ring kernel on the interpret
    machine returns the replicated concatenation the port's shards
    receive."""
    rng = np.random.default_rng(len(shape))
    x = _words(rng, shape)
    want = np.asarray(ring_all_gather(
        jmesh8, jnp.asarray(x.astype(np.uint32)), "sp",
        interpret_mode="sim"), np.int64)
    for out in CL.all_gather(_shards(x, 8)):
        np.testing.assert_array_equal(out.numpy(), want)


def _a2a_reference(shards, D, split_axis, concat_axis):
    """Tiled all-to-all from its definition: destination j concatenates
    chunk j of every source along concat_axis."""
    return [np.concatenate([np.split(s, D, axis=split_axis)[j]
                            for s in shards], axis=concat_axis)
            for j in range(D)]


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,split_axis,concat_axis",
                         [((8, 24), 1, 0), ((8, 24), 0, 1),
                          ((3, 8, 16), 2, 1), ((3, 16, 8), 1, 2),
                          ((2, 8, 3), 1, 1)])
def test_all_to_all_plain_matches_definition(D, shape, split_axis,
                                             concat_axis):
    rng = np.random.default_rng(D + sum(shape))
    xs = [_words(rng, shape) for _ in range(D)]
    got = CL.all_to_all([torch.as_tensor(x) for x in xs], split_axis,
                        concat_axis)
    want = _a2a_reference(xs, D, split_axis, concat_axis)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("split_axis,concat_axis", [(2, 1), (1, 2)])
def test_all_to_all_matches_jax_a2a_kernel(jmesh8, split_axis,
                                           concat_axis):
    """K9's function: JAX's direct remote-DMA all-to-all on the interpret
    machine, inside shard_map over the 8-device mesh, and lax.all_to_all,
    give the port's shards."""
    rng = np.random.default_rng(split_axis)
    x = _words(rng, (8 * 2, 8, 16))        # local (2, 8, 16) per device

    def run(body):
        fn = jax.jit(jax.shard_map(body, mesh=jmesh8,
                                   in_specs=PartitionSpec("sp"),
                                   out_specs=PartitionSpec("sp"),
                                   check_vma=False))
        return np.asarray(fn(jnp.asarray(x.astype(np.uint32))), np.int64)

    want = run(lambda xl: all_to_all_in_body("sp", 8, xl, split_axis,
                                             concat_axis, "sim"))
    np.testing.assert_array_equal(want, run(lambda xl: jax.lax.all_to_all(
        xl, "sp", split_axis, concat_axis, tiled=True)))
    got = CL.all_to_all(_shards(x, 8), split_axis, concat_axis)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


# csrc/collectives.cu's K9 cannot run here; _k9_model runs its index map:
# the host plan (CL.a2a_plan) in the launch's copy units, the grid and the
# thread index as all_to_all_launch and all_to_all_kernel derive them.

_THREADS, _BATCH = 256, CL.A2A_BATCH     # collectives.cu THREADS, kBatch


def _k9_model(shards, split_axis: int, concat_axis: int):
    """all_to_all as K9 computes it, each destination unit written by the
    thread the kernel gives it; asserts each is written exactly once."""
    D, x = len(shards), shards[0]
    es = x.element_size()
    plan = CL.a2a_plan(tuple(x.shape), D, split_axis, concat_axis)
    lengths = [plan.run, plan.sb, plan.sr, plan.db, plan.dr, plan.src_pair,
               plan.dst_pair]
    k = CL._unit([v * es for v in lengths]) // es       # elements a unit
    run, sb, sr, db, dr, sp, dp = (v // k for v in lengths)
    tx_bits = 0
    while tx_bits < 8 and (1 << tx_bits) < run:
        tx_bits += 1
    nseg = -(-run // (1 << tx_bits))
    gx = -(-plan.nr // (_THREADS >> tx_bits)) * nseg
    gy = min(-(-plan.nb // _BATCH), 65535)
    t = torch.arange(_THREADS)[None, :]
    bx = torch.arange(gx)[:, None]
    u = (bx % nseg << tx_bits) + (t & ((1 << tx_bits) - 1))
    r = (bx // nseg << (8 - tx_bits)) + (t >> tx_bits)
    live = (u < run) & (r < plan.nr)
    u, r = u[live], r[live]
    outs = [torch.full((D,) + plan.out_shape, -1, dtype=x.dtype)[0]
            for _ in range(D)]
    src = [sh.reshape(-1, k) for sh in shards]
    dst = [o.view(-1, k) for o in outs]
    hits = [torch.zeros(o.shape[0], dtype=torch.int64) for o in dst]
    for z in range(D * D):
        s, j = divmod(z, D)
        for by in range(gy):
            for b0 in range(by * _BATCH, plan.nb, gy * _BATCH):
                for b in range(b0, min(b0 + _BATCH, plan.nb)):
                    di = s * dp + b * db + r * dr + u
                    dst[j][di] = src[s][j * sp + b * sb + r * sr + u]
                    hits[j].index_add_(0, di, torch.ones_like(di))
    assert all(bool((h == 1).all()) for h in hits)
    return outs


# every exchange shape of the sharded 2^16 proof on 8 shards (chip_smoke.py
# dist_cases: the transposes of the 2^18 coset transforms and of the 2^16
# interpolations, both ways), then D = 1, odd rows, split == concat, a
# batch of two leading axes
A2A_CASES = ([(8, lead + shape, len(lead) + sp, len(lead) + ct)
              for r, leads in ((512, ((5,), (10,), ())),
                               (256, ((9,), (3,), ())))
              for lead in leads
              for shape, sp, ct in (((r // 8, r), 1, 0),
                                    ((r, r // 8), 0, 1))]
             + [(1, (3, 7), 1, 0), (8, (3, 8, 5), 1, 2), (8, (16, 24), 0, 0),
                (8, (2, 3, 16, 64), 3, 2)])


def _jax_a2a(x: np.ndarray, D: int, split_axis: int, concat_axis: int,
             pallas: bool) -> np.ndarray:
    """The shards of x (D of them along axis 0) through JAX's Pallas
    all-to-all on the interpret machine, or lax.all_to_all, inside
    shard_map over a D-device CPU mesh, concatenated."""
    mesh = JMS.make_1d_mesh("sp", D)

    def body(xl):
        if pallas:
            return all_to_all_in_body("sp", D, xl, split_axis, concat_axis,
                                      "sim")
        return jax.lax.all_to_all(xl, "sp", split_axis, concat_axis,
                                  tiled=True)

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=PartitionSpec("sp"),
                               out_specs=PartitionSpec("sp"),
                               check_vma=False))
    return np.asarray(fn(jnp.asarray(x.astype(np.uint32))), np.int64)


@pytest.mark.parametrize("D,shape,split_axis,concat_axis", A2A_CASES)
def test_all_to_all_plan_model_matches_plain_and_jax(D, shape, split_axis,
                                                     concat_axis):
    """K9's index map equals all_to_all_plain and lax.all_to_all at the
    shape, and JAX's Pallas all-to-all (interpret mode, whose cost grows
    steeply with size: minutes at 40 k words a shard) at the shape with
    its trailing axes cut by 8 where they are longer than 8 (same batch,
    axes and D)."""
    rng = np.random.default_rng(sum(shape) + D)
    small = tuple(n // 8 if i and n > 8 else n for i, n in enumerate(shape))
    for sh, pallas in ((shape, False), (small, True)):
        xs = [_words(rng, sh) for _ in range(D)]
        shards = [torch.as_tensor(x) for x in xs]
        got = _k9_model(shards, split_axis, concat_axis)
        want = CL.all_to_all_plain(shards, split_axis, concat_axis)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        jwant = _jax_a2a(np.concatenate(xs), D, split_axis, concat_axis,
                         pallas)
        np.testing.assert_array_equal(torch.cat(got).numpy(), jwant)


def test_a2a_plan_axes():
    """The plan merges what both layouts keep contiguous: the 2^18 path's
    transposes are 5 x 64 rows of 64-word runs, a split equal to the
    concat axis leading one run per pair; without a batch axis the rows
    fold into 4 batch groups, and a lone run longer than 64 words into
    rows of 64 first."""
    assert CL.a2a_plan((5, 64, 512), 8, 2, 1)[:7] == (5, 64, 64, 64 * 512,
                                                      512, 512 * 64, 64)
    assert CL.a2a_plan((5, 512, 64), 8, 1, 2)[:7] == (5, 64, 64, 512 * 64,
                                                      64, 64 * 512, 512)
    assert CL.a2a_plan((40,), 8, 0, 0)[:3] == (1, 1, 5)
    assert CL.a2a_plan((16, 24), 8, 0, 0)[:3] == (1, 1, 48)
    assert CL.a2a_plan((3, 8, 5), 8, 1, 2).out_shape == (3, 1, 40)
    assert CL.a2a_plan((64, 512), 8, 1, 0)[:7] == (4, 16, 64, 16 * 512,
                                                   512, 16 * 64, 64)
    assert CL.a2a_plan((8 * 20480,), 8, 0, 0)[:7] == (4, 80, 64, 80 * 64,
                                                      64, 80 * 64, 64)


def test_exchange_selection():
    x = [torch.arange(4), torch.arange(4, 8)]
    assert CL.resolve_exchange(None, x[0].device) == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        CL.all_gather(x, exchange="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        CL.all_to_all(x, 0, 0, exchange="cuda")
    with pytest.raises(ValueError, match="exchange"):
        CL.all_gather(x, exchange="xla")


def test_exchange_refuses_bad_shards():
    """The wrappers' preconditions, checked before any copy: overlapping
    destinations, dtype and size mismatches, non-contiguous shards, more
    than 16 shards, a split that does not divide."""
    src = [torch.arange(8), torch.arange(8, 16)]
    buf = torch.zeros(40, dtype=torch.int64)
    with pytest.raises(ValueError, match="overlaps"):
        CL.all_to_all_into(src, [src[0], torch.zeros(8, dtype=torch.int64)])
    with pytest.raises(ValueError, match="overlaps"):
        CL.all_gather_into(src, [buf[:16], buf[8:24]])
    with pytest.raises(TypeError, match="dtype"):
        CL.all_gather_into(src, [torch.zeros(16, dtype=torch.int32),
                                 torch.zeros(16, dtype=torch.int32)])
    with pytest.raises(ValueError, match="expected"):
        CL.all_gather_into(src, [buf[:16], buf[16:30]])
    with pytest.raises(ValueError, match="expected"):
        CL.all_to_all_into([torch.arange(3), torch.arange(3)],
                           [buf[:3], buf[3:6]])
    with pytest.raises(ValueError, match="contiguous"):
        CL.all_gather_into(src, [buf[:32:2], buf[32:40].repeat(2)])
    many = [torch.arange(2) for _ in range(17)]
    with pytest.raises(ValueError, match="1..16"):
        CL.all_gather(many)
    with pytest.raises(ValueError, match="divide"):
        CL.all_to_all([torch.arange(6), torch.arange(6)] * 2, 0, 0)


def test_mesh_shards_and_devices():
    mesh = MS.make_1d_mesh("sp", 4, device="cpu")
    assert mesh.shape == {"sp": 4} and mesh.device == torch.device("cpu")
    x = torch.arange(24).reshape(2, 12)
    shards = MS.shard_vector(mesh, x)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert all(s.is_contiguous() for s in shards)
    assert torch.equal(MS.unshard_vector(shards), x)
    with pytest.raises(ValueError, match="split"):
        MS.shard_vector(mesh, torch.arange(6))
    # several cards are not supported yet: raise, never carry on
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        MS.Mesh("sp", (torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="one device"):
        MS.Mesh("sp", (torch.device("cpu"), torch.device("cuda", 0)))
    # the default device is the card: without one, make_1d_mesh raises
    if torch.cuda.is_available():
        assert MS.make_1d_mesh("sp", 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MS.make_1d_mesh("sp", 2)
