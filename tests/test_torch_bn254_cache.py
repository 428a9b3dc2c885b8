"""The BN254 SRS and window-table disk caches of the port
(plonk_tpu_torch.models.plonk_bn254: bn254_setup(cache=True),
bn254_fixed_base_table) against the JAX package's files, on the CPU at
n = 8, with HOME and PLONK_TPU_CACHE pointed at a temporary directory.

- the SRS file of the JAX package's own bn254_setup(8, 987654321)
  (recorded once in tests/golden/bn254_srs_n8_s987654321_jax.npz: JAX's
  setup compiles for minutes on XLA:CPU; `-k recompute` under
  PLONK_TPU_HEAVY_TESTS makes it anew and compares) loads in the port and
  equals the port's SRS word for word; the port's file loads in JAX's
  bn254_setup, word for word, with JAX's fields and uint32 words;
- the table: the port's file loads in JAX's bn254_fixed_base_table under
  JAX's key (JAX builds nothing); a file written by JAX's
  bn254_fixed_base_table (its build_big_table stood in for by the port's
  table, so that only JAX's chunking, key and writer run) has the port's
  key and loads in the port;
- a round trip of each in the port (a fresh context loads what the first
  wrote); an unreadable table file is rebuilt, as in the JAX package.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from plonk_tpu.models import plonk_bn254 as JPB
from plonk_tpu_torch.models import plonk_bn254 as PB
from torch_bn254_env import bn254_env

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

N = 8
SECRET = 987654321
SRS_NAME = f"bn254_srs_n{N}_s{SECRET}.npz"
JAX_SRS = os.path.join(os.path.dirname(__file__), "golden",
                       f"bn254_srs_n{N}_s{SECRET}_jax.npz")
SRS_FIELDS = ("x", "y", "inf", "g2_1x", "g2_1y", "g2_sx", "g2_sy")


def _point_caches(mp, root) -> tuple:
    """HOME (the SRS cache's root) and PLONK_TPU_CACHE (the table's) under
    `root` (tests/torch_bn254_env.py) -> (the SRS cache directory, the
    table's)."""
    bn254_env(mp, root, table_route=False)
    return root / "home" / ".cache" / "plonk_tpu", root / "tables"


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port's SRS and window table, computed by bn254_setup and
    bn254_fixed_base_table with empty caches, which write them: (context,
    table, the SRS file, the table file)."""
    with pytest.MonkeyPatch.context() as mp:
        srs_dir, tbl_dir = _point_caches(mp, tmp_path_factory.mktemp("w"))
        ctx = PB.bn254_setup(N, secret=SECRET, device="cpu")
        tbl = PB.bn254_fixed_base_table(ctx)
    assert os.listdir(srs_dir) == [SRS_NAME] and len(os.listdir(tbl_dir)) == 1
    return ctx, tbl, srs_dir / SRS_NAME, tbl_dir / os.listdir(tbl_dir)[0]


@pytest.fixture
def cache_dirs(tmp_path, monkeypatch):
    return _point_caches(monkeypatch, tmp_path)


def _put(src, dst_dir, name=None):
    dst_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst_dir / (name or os.path.basename(src)))


def _srs_arrays(srs) -> dict:
    """An SRS of either package as numpy arrays under the file's names."""
    g = srs.g1s
    return {k: np.asarray(v) for k, v in zip(
        SRS_FIELDS, (g.x, g.y, g.inf, srs.g2_1x, srs.g2_1y, srs.g2_sx,
                     srs.g2_sy))}


def _same_srs(a, b) -> bool:
    return a.length == b.length and all(
        np.array_equal(u.astype(np.int64), v.astype(np.int64))
        for u, v in zip(_srs_arrays(a).values(), _srs_arrays(b).values()))


def _same_table(a, b) -> bool:
    return all(np.array_equal(np.asarray(u).astype(np.int64),
                              np.asarray(v).astype(np.int64))
               for u, v in zip((a.x, a.y, a.inf), (b.x, b.y, b.inf)))


def test_written_srs_is_the_computed_one(written):
    """bn254_setup with an empty cache computes the SRS (the words of the
    JAX package's file) and writes JAX's fields: uint32 words, bool
    flags, each Fq2 as (2, 16), the length."""
    ctx, _, srs_file, _ = written
    with np.load(JAX_SRS) as z:
        assert all(np.array_equal(a.astype(np.int64), z[k])
                   for k, a in _srs_arrays(ctx.srs).items())
        assert int(z["length"]) == ctx.srs.length
    with np.load(srs_file) as z:
        assert sorted(z.files) == sorted(SRS_FIELDS + ("length",))
        assert all(z[k].dtype == np.uint32 for k in SRS_FIELDS if k != "inf")
        assert z["inf"].dtype == bool and z["g2_sx"].shape == (2, 16)
        assert int(z["length"]) == N + 5


def test_jax_srs_file_loads_in_the_port(written, cache_dirs):
    _put(JAX_SRS, cache_dirs[0], SRS_NAME)
    ctx = PB.bn254_setup(N, secret=SECRET, device="cpu")
    assert ctx.srs.g1s.x.dtype == torch.int64
    assert _same_srs(ctx.srs, written[0].srs)


def test_port_srs_file_loads_in_jax(written, cache_dirs):
    _put(written[2], cache_dirs[0])
    jctx = JPB.bn254_setup(N, secret=SECRET, rolled=True)
    assert _same_srs(jctx.srs, written[0].srs)


def test_srs_round_trip(written, cache_dirs, monkeypatch):
    """A second bn254_setup loads the file the first wrote: nothing is
    computed (the generator table is not asked for)."""
    _put(written[2], cache_dirs[0])
    monkeypatch.setattr(PB, "_generator_table", None)
    again = PB.bn254_setup(N, secret=SECRET, device="cpu")
    assert _same_srs(again.srs, written[0].srs) and again.n == N


def test_port_table_file_loads_in_jax_under_its_key(written, cache_dirs):
    ctx, tbl, srs_file, tbl_file = written
    assert tbl_file.name == os.path.basename(PB._fb_cache_path(ctx, 4))
    with np.load(tbl_file) as z:
        assert sorted(z.files) == ["inf", "x", "y"]
        assert z["x"].dtype == np.uint32 and z["inf"].dtype == bool
        assert z["x"].shape == (64, 16, N + 5, 16)
    _put(srs_file, cache_dirs[0])
    _put(tbl_file, cache_dirs[1])
    jctx = JPB.bn254_setup(N, secret=SECRET, rolled=True)
    assert _same_table(JPB.bn254_fixed_base_table(jctx), tbl)
    assert os.listdir(cache_dirs[1]) == [tbl_file.name]   # found, not built


def test_jax_table_file_loads_in_the_port(written, cache_dirs, monkeypatch):
    """JAX's bn254_fixed_base_table writes the table under its key; its
    build_big_table returns the port's table (JAX's build compiles for
    minutes), so the file is JAX's chunking, key and writer over known
    words."""
    from plonk_tpu.ops import bigcurve as JBC
    ctx, tbl, _, tbl_file = written
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    fake = JBC.BigFixedBaseTable(u32(tbl.x), u32(tbl.y),
                                 jnp.asarray(tbl.inf.numpy()), 4)
    monkeypatch.setattr(JBC, "build_big_table", lambda *a, **k: fake)
    g = ctx.srs.g1s
    jsrs = JPB.BN254SRS(g1s=JPB.BigG1Affine(u32(g.x), u32(g.y),
                                            jnp.asarray(g.inf.numpy())),
                        g2_1x=None, g2_1y=None, g2_sx=None, g2_sy=None,
                        length=ctx.srs.length)
    JPB.bn254_fixed_base_table(JPB.BN254Context(srs=jsrs, n=N))
    assert os.listdir(cache_dirs[1]) == [tbl_file.name]   # the port's key
    loaded = PB._fb_disk_load(PB.BN254Context(srs=ctx.srs, n=N), 4)
    assert loaded is not None and _same_table(loaded, tbl)


def test_table_round_trip(written, cache_dirs, monkeypatch):
    """A fresh context loads the table the first wrote; nothing is
    built."""
    ctx, tbl, _, tbl_file = written
    _put(tbl_file, cache_dirs[1])
    monkeypatch.setattr(PB, "build_big_table", None)
    fresh = PB.BN254Context(srs=ctx.srs, n=N)
    assert _same_table(PB.bn254_fixed_base_table(fresh), tbl)
    assert PB.bn254_packed_table(fresh) is None            # CPU: no K4


def test_unreadable_table_file_is_rebuilt(written, cache_dirs, monkeypatch):
    """An unreadable file is skipped, the table built (by a
    build_big_table that hands back the written table: the build itself
    is the `written` fixture's) and the file written anew, as the JAX
    package does."""
    ctx, tbl, _, tbl_file = written
    cache_dirs[1].mkdir(parents=True)
    (cache_dirs[1] / tbl_file.name).write_bytes(b"not an npz file")
    fresh = PB.BN254Context(srs=ctx.srs, n=N)
    assert PB._fb_disk_load(fresh, 4) is None
    built = []
    monkeypatch.setattr(PB, "build_big_table",
                        lambda *a: built.append(a) or tbl)
    assert _same_table(PB.bn254_fixed_base_table(fresh), tbl)
    assert len(built) == 1 and built[0][2:] == (4, PB.FR_BITS)
    again = PB._fb_disk_load(fresh, 4)
    assert again is not None and _same_table(again, tbl)


def test_window_bits_switch(monkeypatch):
    """PLONK_TPU_BN254_FB_WB picks the table's width (default 4, JAX's)
    and refuses widths the digits cannot take."""
    monkeypatch.delenv("PLONK_TPU_BN254_FB_WB", raising=False)
    assert PB.bn254_fb_window_bits() == 4
    monkeypatch.setenv("PLONK_TPU_BN254_FB_WB", "8")
    assert PB.bn254_fb_window_bits() == 8
    for bad in ("0", "17"):
        monkeypatch.setenv("PLONK_TPU_BN254_FB_WB", bad)
        with pytest.raises(ValueError, match=f"PLONK_TPU_BN254_FB_WB={bad}"):
            PB.bn254_fb_window_bits()


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="runs the JAX package's BN254 setup (minutes of "
                           "XLA:CPU); set PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_srs_file(cache_dirs):
    """JAX's bn254_setup writes the recorded file's arrays anew."""
    srs_dir, _ = cache_dirs
    JPB.bn254_setup(N, secret=SECRET, rolled=True)
    with np.load(srs_dir / SRS_NAME) as new, np.load(JAX_SRS) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in new.files:
            assert new[k].dtype == old[k].dtype
            np.testing.assert_array_equal(new[k], old[k])
