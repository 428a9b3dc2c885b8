"""BN254 G1 (plonk_tpu_torch/ops/bigcurve.py) and K4's plain version
(ops/bigcommit.py::big_commit_many_plain) against the JAX package on the
same inputs, on the CPU, and against the python-int oracle
(tests/bn254_oracle.py). Points are compared in affine form, words equal
(tolerance zero): Jacobian representatives may differ, group elements
may not.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bn254_oracle as O
from plonk_tpu.ops import bigcurve as JBC
from plonk_tpu.ops.bigfield import BigMontField as JBigMontField
from plonk_tpu_torch.models.synthetic import words_vec
from plonk_tpu_torch.ops import bigcommit as BK
from plonk_tpu_torch.ops import bigcurve as BC
from plonk_tpu_torch.ops.bigfield import BigMontField

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

F = BigMontField(BC.BN254_FQ)
JF = JBigMontField(JBC.BN254_FQ, rolled=True)
R = O.R


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _jac(pts):
    return JBC.BigG1J(*(_u32(c) for c in pts))


def _affine_np(aff):
    return tuple(np.asarray(a).astype(np.int64) for a in aff[:2]) + (
        np.asarray(aff[2]),)


def _assert_affine_equal(got, want):
    gx, gy, ginf = (a.numpy() for a in got)
    wx, wy, winf = want
    assert np.array_equal(ginf, winf)
    assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def _multiples(ks):
    """k * G for each small integer k (negative: the opposite point), as
    a Jacobian batch made by the port's ladder."""
    g = BC.bn254_generator(F, (len(ks),), "cpu")
    nbits = max(abs(k) for k in ks).bit_length()
    bits = np.stack([BC.scalar_to_bits(abs(k), nbits) for k in ks])
    p = BC.big_jac_mul(F, g, bits, nbits)
    neg = torch.as_tensor([k < 0 for k in ks])[:, None]
    return BC.BigG1J(p.X, torch.where(neg, F.neg(p.Y), p.Y), p.Z)


@pytest.fixture(scope="module")
def points():
    """P and Q batches covering a generic sum, a doubling (P == Q), an
    inverse pair (Q == -P) and an infinity operand on either side."""
    p = _multiples([3, 5, 7, 11, 0])
    q = _multiples([4, 5, -7, 0, 13])
    return p, q


def test_multiples_match_oracle(points):
    p, q = points
    x, y, inf = BC.big_to_affine(F, p)
    assert inf.tolist() == [False, False, False, False, True]
    for i, k in enumerate([3, 5, 7, 11]):
        got = (int(F.decode_host(x[i])), int(F.decode_host(y[i])))
        assert got == O.g1_mul(O.G1_GEN, k)


@pytest.mark.parametrize("op", ["add", "double", "to_affine"])
def test_group_ops_match_jax(points, op):
    p, q = points
    if op == "add":
        got = BC.big_to_affine(F, BC.big_jac_add(F, p, q))
        want = jax.jit(lambda a, b: JBC.big_to_affine(
            JF, JBC.big_jac_add(JF, a, b)))(_jac(p), _jac(q))
    elif op == "double":
        got = BC.big_to_affine(F, BC.big_jac_double(F, p))
        want = jax.jit(lambda a: JBC.big_to_affine(
            JF, JBC.big_jac_double(JF, a)))(_jac(p))
    else:
        got = BC.big_to_affine(F, p)
        want = jax.jit(lambda a: JBC.big_to_affine(JF, a))(_jac(p))
    _assert_affine_equal(got, _affine_np(want))
    if op == "add":                   # 3+4, 2*5, 7-7 = inf, 11+inf, inf+13
        assert got[2].tolist() == [False, False, True, False, False]


def test_on_curve_matches_jax(points):
    """Real points lie on the curve; a point with y + 1 does not."""
    x, y, _ = BC.big_to_affine(F, points[0])
    x, y = x[:4], torch.cat([y[:3], F.add(y[3:4], F.const(1))])
    got = BC.big_on_curve(F, x, y)
    want = jax.jit(lambda a, b: JBC.big_on_curve(JF, a, b))(_u32(x), _u32(y))
    assert got.tolist() == [True, True, True, False]
    assert got.tolist() == np.asarray(want).tolist()


@jax.jit
def _jax_mul16(bits):
    """JAX's ladder over 16 bits from the generator, 5 lanes (one compile
    for every case below)."""
    g = JBC.bn254_generator(JF, shape=(5,))
    return JBC.big_to_affine(JF, JBC.big_jac_mul(JF, g, bits, 16))


@pytest.mark.parametrize("ks", [[0, 1, 2, 0xBEEF, 0xFFFF],
                                [0, 4, 8, 12, 0]])  # bits 0, 1, 4.. unset
def test_jac_mul_matches_jax(ks):
    """Host (numpy) bits skip the additions no lane needs; device bits
    take every step. Both equal JAX's ladder."""
    g = BC.bn254_generator(F, (len(ks),), "cpu")
    bits = np.stack([BC.scalar_to_bits(k, 16) for k in ks])
    got = BC.big_to_affine(F, BC.big_jac_mul(F, g, bits, 16))
    every_step = BC.big_to_affine(
        F, BC.big_jac_mul(F, g, torch.as_tensor(bits), 16))
    _assert_affine_equal(got, tuple(a.numpy() for a in every_step))
    want = _jax_mul16(jnp.asarray(bits, jnp.uint32))
    _assert_affine_equal(got, _affine_np(want))


@pytest.fixture(scope="module")
def table8():
    """4-bit window tables over 32-bit scalars of 8 points (one at
    infinity), built by the port and by JAX."""
    pts = _multiples([2, 9, 9, -9, 0, 17, 23, 1 << 40])
    tbl = BC.build_big_table(F, pts, 4, 32)
    jt = jax.jit(lambda p: JBC.build_big_table(JF, p, 4, 32))(_jac(pts))
    return tbl, JBC.BigFixedBaseTable(jt.x, jt.y, jt.inf, 4)


def test_build_big_table_matches_jax(table8):
    tbl, jt = table8
    assert tuple(tbl.x.shape) == tuple(jt.x.shape) == (8, 16, 8, 16)
    assert np.array_equal(tbl.inf.numpy(), np.asarray(jt.inf))
    assert np.array_equal(tbl.x.numpy(), np.asarray(jt.x).astype(np.int64))
    assert np.array_equal(tbl.y.numpy(), np.asarray(jt.y).astype(np.int64))


def test_pack_commit_table_matches_table_words(table8):
    """K4's packed table holds the table's words (those JAX's build gives,
    test above) as 32-bit limbs, x then y; unpacking gives them back."""
    tbl, jt = table8
    packed = BK.pack_commit_table(tbl)
    assert packed.dtype == torch.int32
    assert tuple(packed.shape) == (8, 16, 8, 16) and packed.is_contiguous()
    limbs = packed.numpy().astype(np.uint32).astype(np.int64)
    for half, words in ((0, np.asarray(jt.x)), (1, np.asarray(jt.y))):
        w = words.astype(np.int64)
        assert np.array_equal(limbs[..., 8 * half:8 * half + 8],
                              w[..., 0::2] | (w[..., 1::2] << 16))
    x, y = BK.unpack_commit_table(packed)
    assert torch.equal(x, tbl.x) and torch.equal(y, tbl.y)


def _scalars(B, L, seed):
    """(B, L, 2) 32-bit scalars as 16-bit words, lane (0, 0) zero."""
    rng = np.random.default_rng(seed)
    sc = rng.integers(0, 1 << 16, size=(B, L, 2)).astype(np.int64)
    sc[0, 0] = 0
    return torch.as_tensor(sc)


# 254-bit scalars over seven bases: four multiples k*G, a repeated base, an
# opposite one and the point at infinity. All 64 windows are reached.
FULL_SEED = 12
# the affine commitments (standard form) of _full_width_case(), recorded
# once from the JAX package's Pallas kernel in interpret mode, as
#
#     PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \
#         tests/test_torch_bigcurve.py -k recompute
#
# prints them (big_commit_many_pallas(..., interpret=True, version="v3"),
# the kernel's default tile 128 and wg = 8; two hours on one CPU core,
# most of it XLA compiling the interpreted kernel)
FULL_PALLAS = [
    (0x2bd3baf031a5c14b67cee96f74eac82bb82f4902d2550d535e9daa1dd2b6a8d6,
     0x152be138973a0260ac1ca1ce6e695edb69f775d87f7c156c61633f75b2cf7625),
    (0xa0d8fbbc7813b97cb9156908ea8967121d217f44729542ce4a2decdcbb1a737,
     0x1590c0ff4fe53707ed48eaa7a2c07304f126658c01a3ef9c11e7bf60d4bbd14e),
    (0x194309a8a3a1ebcfcbb42bf7a9fa8910748fa985af2e5f58430886d9ed42ad20,
     0x11ae7185221f822140b2f56dc2c91f1823841d0c034cb24654dc69ad2c7db178),
]


@pytest.fixture(scope="module")
def full_width():
    """(base multiples, scalars as ints, the port's window table over 254
    bits, the (3, 7, 16) scalar words, K4's plain commitments, affine)."""
    rng = np.random.default_rng(FULL_SEED)
    ks = [int(rng.integers(1, 1 << 40)) for _ in range(4)]
    ks += [ks[1], -ks[2], 0]
    vals = [[int.from_bytes(rng.bytes(32), "little") % R for _ in ks]
            for _ in range(3)]
    vals[0][0] = 0
    vals[2][4] = vals[2][1]     # the repeated base, same scalar: a doubling
    vals[2][5] = vals[2][2]     # the opposite base, same scalar: cancels
    tbl = BC.build_big_table(F, _multiples(ks), 4, 254)
    sc = torch.as_tensor(np.stack([words_vec(v) for v in vals]).astype(
        np.int64))
    got = BC.big_to_affine(F, BK.big_commit_many_plain(F, tbl, sc))
    return ks, vals, tbl, sc, got


def _jax_table(tbl):
    return JBC.BigFixedBaseTable(_u32(tbl.x), _u32(tbl.y),
                                 jnp.asarray(tbl.inf.numpy()), 4)


def _jac_to_affine_np(jac):
    """A JAX Jacobian batch made affine by the port."""
    aff = BC.big_to_affine(F, BC.BigG1J(*(torch.as_tensor(
        np.asarray(c).astype(np.int64)) for c in jac)))
    return tuple(a.numpy() for a in aff)


def test_commit_plain_full_width_matches_oracle(full_width):
    ks, vals, _, _, got = full_width
    assert not bool(got[2].any())
    for b in range(3):
        want = O.g1_mul(O.G1_GEN, sum(s * k for s, k in zip(vals[b], ks)) % R)
        assert (int(F.decode_host(got[0][b])),
                int(F.decode_host(got[1][b]))) == want


def test_commit_plain_matches_jax(full_width):
    """K4's plain version against the JAX package's XLA select sweep
    (big_msm_fixed_base_many, which test_pallas_bigmsm.py holds the Pallas
    kernel against) at full width: 254-bit scalars, 64 windows, B = 3.
    The sweep runs op by op: jitted, its compile grows with its tree
    (two minutes at that test's 5 points and 32-bit scalars)."""
    _, _, tbl, sc, got = full_width
    want = JBC.big_msm_fixed_base_many(JF, _jax_table(tbl), _u32(sc))
    _assert_affine_equal(got, _jac_to_affine_np(want))


def test_commit_plain_matches_recorded_pallas(full_width):
    """K4's plain version against the JAX Pallas kernel's recorded
    output on the same inputs (FULL_PALLAS)."""
    got = full_width[4]
    for b, (x, y) in enumerate(FULL_PALLAS):
        assert (int(F.decode_host(got[0][b])),
                int(F.decode_host(got[1][b]))) == (x, y)


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="runs the JAX Pallas commit kernel in interpret "
                           "mode (two hours of CPU); set "
                           "PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_pallas_commit(full_width):
    from plonk_tpu.ops.pallas_bigmsm import big_commit_many_pallas
    _, _, tbl, sc, got = full_width
    want = jax.jit(lambda t, s: big_commit_many_pallas(
        JF, t, s, interpret=True, version="v3"))(_jax_table(tbl), _u32(sc))
    want = _jac_to_affine_np(want)
    for b in range(3):
        print(f"    ({hex(int(F.decode_host(torch.as_tensor(want[0][b]))))},"
              f"\n     {hex(int(F.decode_host(torch.as_tensor(want[1][b]))))}),")
    _assert_affine_equal(got, want)
    test_commit_plain_matches_recorded_pallas(full_width)


def test_commit_plain_edge_cases(table8):
    """Zero scalars, repeated, opposite and infinity bases: the plain
    commit equals the python-int sum of s_i * P_i."""
    tbl, _ = table8
    ks = [2, 9, 9, R - 9, 0, 17, 23, 1 << 40]
    sc = _scalars(3, 8, 6)
    sc[1] = 0                                  # an all-zero commitment
    sc[2, :, :] = sc[0, :, :]
    sc[2, 2] = sc[2, 1]                        # 9G twice, then -9G
    sc[2, 3] = sc[2, 1]
    got = BC.big_to_affine(F, BK.big_commit_many_plain(F, tbl, sc))
    assert got[2].tolist() == [False, True, False]
    for b in (0, 2):
        s = [int(w[0]) | (int(w[1]) << 16) for w in sc[b]]
        want = O.g1_mul(O.G1_GEN, sum(si * k for si, k in zip(s, ks)) % R)
        assert (int(F.decode_host(got[0][b])),
                int(F.decode_host(got[1][b]))) == want


def test_commit_digits_mask_infinity_bases(table8):
    tbl, _ = table8
    d = BK.commit_digits(tbl, _scalars(2, 8, 7))
    assert d.shape == (2, 8, 8)
    assert bool((d[:, :, 4] == 0).all())        # base 4 is infinity
