"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX.)
"""
import numpy as np
import pytest
import torch

from plonk_tpu_torch.utils.params import SCALED_CURVE, SCALED_FQ, SCALED_FR
from plonk_tpu_torch.models import fiat_shamir as FS
from plonk_tpu_torch.models import fs_poseidon as FSP
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.synthetic import edge_rows, square_chain_circuit
from plonk_tpu_torch.ops import commit as CM
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops import poseidon as PO
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.ops.row_stages import row_stages, row_stages_plain
from plonk_tpu_torch.utils import kernels
from torch_bn254_env import bn254_env

pytestmark = pytest.mark.cuda

Fr, Fq = MontField(SCALED_FR), MontField(SCALED_FQ)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("C", [1 << s for s in range(1, 11)])
@pytest.mark.parametrize("R", [1, 3, 576, 1280])
def test_row_stages_kernel_matches_plain(dev, R, C):
    """K1 on random rows and on edge rows (zeros, r - 1, and pairs whose
    first sum is exactly r, K1's lazy residues at their edge), one launch
    a call."""
    n = C << (R - 1).bit_length()      # a transform size with R rows or more
    w = SCALED_FR.root_of_unity(n)
    intra, _ = N._device_tables(Fr, w, n, C, dev)
    rng = np.random.default_rng(R + C)
    for vals in (rng.integers(0, Fr.p, size=(R, C)),
                 edge_rows(Fr.p, R, C, rng)):
        y = torch.as_tensor(vals, device=dev)
        before = kernels.LAUNCHES["row_stages"]
        got = row_stages(Fr.p, Fr.n_prime, y, intra)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["row_stages"] == before + 1
        assert torch.equal(got, row_stages_plain(Fr.p, Fr.n_prime, y, intra))


@pytest.mark.parametrize("R,C", [(4096, 1024), (40000, 64), (900000, 2)])
def test_row_stages_kernel_walks_tiles(dev, R, C):
    """More tiles of 2048 words than the grid holds: each block walks
    several, loading the next one's words ahead."""
    n = C << (R - 1).bit_length()
    intra, _ = N._device_tables(Fr, SCALED_FR.root_of_unity(n), n, C, dev)
    y = torch.as_tensor(np.random.default_rng(R).integers(0, Fr.p,
                                                          size=(R, C)),
                        device=dev)
    assert torch.equal(row_stages(Fr.p, Fr.n_prime, y, intra),
                       row_stages_plain(Fr.p, Fr.n_prime, y, intra))


def test_row_stages_kernel_refuses_other_tables(dev):
    """K1 shares a twiddle between a pair's lanes: a table that is not
    lane-periodic is refused on the card, before any launch."""
    intra, _ = N._device_tables(Fr, SCALED_FR.root_of_unity(1 << 13),
                                1 << 13, 1024, dev)
    bad = intra.clone()
    bad[5, 100] = bad[5, 101]
    y = torch.zeros((2, 1024), dtype=torch.int64, device=dev)
    before = kernels.LAUNCHES["row_stages"]
    with pytest.raises(ValueError, match="periodic"):
        row_stages(Fr.p, Fr.n_prime, y, bad)
    assert kernels.LAUNCHES["row_stages"] == before


@pytest.mark.parametrize("n,batch", [(4096, 1), (4096, 3), (1 << 14, 2)])
def test_ntt_on_cuda_matches_cpu(dev, n, batch):
    w = SCALED_FR.root_of_unity(n)
    x = torch.randint(0, Fr.p, (batch, n),
                      generator=torch.Generator().manual_seed(n))
    want = N.ntt(Fr, x, w)
    before = kernels.LAUNCHES["row_stages"]
    assert torch.equal(N.ntt(Fr, x.to(dev), w).cpu(), want)
    assert torch.equal(N.intt(Fr, want.to(dev), w).cpu(), x)
    # every blocked transform on the card goes through K1, however few rows
    assert kernels.LAUNCHES["row_stages"] == before + 2


def _assert_affine_equal(a: C.G1, b: C.G1):
    assert torch.equal(a.inf, b.inf)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)


def _commit_points(rng, L):
    """L points of the scaled curve: small multiples of the generator,
    every third one negated, with repeats, so that equal, inverse and
    infinity bases all occur."""
    r = SCALED_CURVE.r
    ks = rng.integers(0, 40, size=L)
    ks[1::3] = r - ks[1::3]
    g = C.g1_generator(SCALED_CURVE, Fq, "cuda:0")
    return C.g1_mul(Fq, g, torch.as_tensor(ks % r, device="cuda:0"),
                    nbits=r.bit_length())


@pytest.mark.parametrize("L", [1, 40, 513, 1000, 8193, 65542])
@pytest.mark.parametrize("B", [1, 9])
def test_commit_kernel_matches_plain(dev, L, B):
    """K2 against its plain version, affine-equal, with one launch a call;
    L = 1 makes one tile of one point, L = 513 tiles of 256 and 257."""
    rng = np.random.default_rng(L + B)
    r = SCALED_CURVE.r
    tbl = CM.build_commit_table(Fq, _commit_points(rng, L), r.bit_length())
    assert tbl.packed is not None
    sc = rng.integers(0, r, size=(B, L))
    sc[0, ::5] = 0
    if B > 1:
        sc[1] = 0
    scalars = torch.as_tensor(sc, device=dev)
    before = kernels.LAUNCHES["commit_many"]
    got = CM.msm_fixed_base_many_kernel(Fq, tbl, scalars)
    assert kernels.LAUNCHES["commit_many"] == before + 1
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    _assert_affine_equal(got, want)
    if B > 1:
        assert bool(got.inf[1])


def test_commit_kernel_edge_batch(dev):
    """Phase 4's edge batch: zero scalars; repeated, opposite and infinity
    bases; scalars r, whose terms of a point sum to infinity inside one
    thread, and 7 * 2^24 + 2^22 - 1, whose top term equals the sum of the
    others (the mixed addition's doubling)."""
    rng = np.random.default_rng(4)
    r = SCALED_CURVE.r
    tbl = CM.build_commit_table(Fq, _commit_points(rng, 4096),
                                r.bit_length())
    sc = rng.integers(0, r, size=(5, 4096))
    sc[0, ::4] = 0
    sc[1] = 0
    sc[3] = r
    sc[4] = 7 * 2 ** 24 + 2 ** 22 - 1
    scalars = torch.as_tensor(sc, device=dev)
    got = CM.msm_fixed_base_many_kernel(Fq, tbl, scalars)
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    _assert_affine_equal(got, want)
    assert got.inf.tolist() == [False, True, False, True, False]
    with pytest.raises(ValueError, match="packed"):
        CM.commit_many(Fq, tbl._replace(packed=None), scalars)


def test_commit_kernel_on_two_streams(dev):
    """K2 launches on two streams may overlap: each stream has its own
    last-block ticket, so both commitments come out right."""
    rng = np.random.default_rng(7)
    r = SCALED_CURVE.r
    tbl = CM.build_commit_table(Fq, _commit_points(rng, 8193), r.bit_length())
    scs = [torch.as_tensor(rng.integers(0, r, size=(9, 8193)), device=dev)
           for _ in range(2)]
    wants = [C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, sc))
             for sc in scs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for _ in range(20):
        outs = []
        for st, sc in zip(streams, scs):
            with torch.cuda.stream(st):
                outs.append(CM.commit_many(Fq, tbl, sc))
        torch.cuda.synchronize()
        for got, want in zip(outs, wants):
            _assert_affine_equal(C.jac_to_affine(Fq, got), want)


def test_proof_on_cuda_matches_cpu(dev):
    n = 16
    ch, rnd = [1111, 2222, 3333, 4444, 5555], list(range(1, 10))
    proofs = []
    for d in ("cpu", dev):
        ctx = PS.scaled_new(n, device=d)
        sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, n)
        proof, diags = PS.make_prover(ctx, sel, cp)(a, b, c, ch, rnd)
        assert bool(diags.all_ok())
        proofs.append(proof)
    for name in POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(proofs[0], name)[k],
                               getattr(proofs[1], name)[k].cpu()), name
    for name in SCALAR_FIELDS:
        assert int(getattr(proofs[0], name)) == int(getattr(proofs[1],
                                                            name)), name
    assert int(proofs[1].r_z) == 91913729


# ---- Fiat–Shamir: the Poseidon sponge and both FS provers on the card ----

def test_poseidon_on_cuda_matches_cpu(dev):
    """permute, a squeeze with rejections (z^n = 1 for n = 2^22) and
    tree_digest give the CPU port's words."""
    pos = PO.make_params(SCALED_FR.p)
    rng = np.random.default_rng(5)
    std = rng.integers(0, SCALED_FR.p, size=(3, 256, 8))
    got = PO.permute(Fr, pos, Fr.array(std, dev))
    assert torch.equal(got.cpu(), PO.permute(Fr, pos, Fr.array(std, "cpu")))
    outs = [PO.squeeze(Fr, pos, Fr.array(std[0], d), pow_n_not_one=1 << 22)
            for d in (dev, "cpu")]
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)
    leaves = torch.as_tensor(rng.integers(0, SCALED_FR.p, size=1 << 12))
    assert torch.equal(PO.tree_digest(Fr, pos, leaves.to(dev)).cpu(),
                       PO.tree_digest(Fr, pos, leaves))


@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_fs_proof_on_cuda_matches_cpu(dev, kind):
    """The n = 16 FS proof on the card equals the CPU port's, nonce and
    challenge included, with one K2 launch a round; it verifies there."""
    n = 16
    rnd = list(range(1, 10))
    outs = []
    for d in ("cpu", dev):
        ctx = PS.scaled_new(n, device=d)
        sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, n)
        prover = (FS.ScaledFsProver if kind == "blake2b"
                  else FSP.PoseidonFsProver)(ctx, sel, cp)
        kernels.reset_counts()
        out, diags = prover.prove(a, b, c, rnd)
        assert bool(diags.all_ok())
        if d != "cpu":
            assert kernels.LAUNCHES["commit_many"] == 4
            verify = (FS.verify_scaled_fs if kind == "blake2b"
                      else FSP.verify_scaled_fs_poseidon)
            assert verify(ctx, prover.vk, out)
        outs.append(out)
    assert outs[0].nonce == outs[1].nonce
    np.testing.assert_array_equal(outs[0].challenge, outs[1].challenge)
    for name in POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(outs[0].proof, name)[k],
                               getattr(outs[1].proof, name)[k].cpu()), name
    for name in SCALAR_FIELDS:
        assert int(getattr(outs[0].proof, name)) == \
            int(getattr(outs[1].proof, name)), name


# ---- K5 (full-row transform), K6 (one-pass four-step), K7 (matmul) ----

@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
@pytest.mark.parametrize("C", [1 << s for s in range(1, 11)])
@pytest.mark.parametrize("R", [1, 3, 512, 2560])
def test_row_transform_kernel_matches_plain(dev, R, C, dif):
    """K5 in both directions on random rows and on edge rows (zeros,
    p - 1, first-stage partners with lo = hi and with hi = p - lo, whose
    sum lands on p: K5's lazy residues at their edge), one launch a
    call."""
    from plonk_tpu_torch.ops import fused_ntt as FN
    from plonk_tpu_torch.ops.row_stages import (row_transform,
                                                row_transform_plain)
    tw = FN._row_tables(Fr, SCALED_FR.root_of_unity(C), C, dev)
    rng = np.random.default_rng(R + C + dif)
    for vals in (rng.integers(0, Fr.p, size=(R, C)),
                 edge_rows(Fr.p, R, C, rng, C // 2 if dif else 1)):
        y = torch.as_tensor(vals, device=dev)
        before = kernels.LAUNCHES["row_transform"]
        got = row_transform(Fr.p, Fr.n_prime, y, tw, dif)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["row_transform"] == before + 1
        assert torch.equal(got,
                           row_transform_plain(Fr.p, Fr.n_prime, y, tw, dif))


@pytest.mark.parametrize("R,C", [(4096, 1024), (40000, 64), (900000, 2)])
def test_row_transform_kernel_walks_tiles(dev, R, C):
    """More tiles than the grid holds, in both directions."""
    from plonk_tpu_torch.ops import fused_ntt as FN
    from plonk_tpu_torch.ops.row_stages import (row_transform,
                                                row_transform_plain)
    tw = FN._row_tables(Fr, SCALED_FR.root_of_unity(C), C, dev)
    y = torch.as_tensor(np.random.default_rng(R).integers(0, Fr.p,
                                                          size=(R, C)),
                        device=dev)
    for dif in (True, False):
        assert torch.equal(row_transform(Fr.p, Fr.n_prime, y, tw, dif),
                           row_transform_plain(Fr.p, Fr.n_prime, y, tw, dif))


def test_row_transform_kernel_refuses_other_tables(dev):
    """K5 shares a twiddle between a pair's lanes: a table that is not
    lane-periodic is refused on the card, before any launch."""
    from plonk_tpu_torch.ops import fused_ntt as FN
    from plonk_tpu_torch.ops.row_stages import row_transform
    bad = FN._row_tables(Fr, SCALED_FR.root_of_unity(512), 512, dev).clone()
    bad[4, 100] = bad[4, 101]
    y = torch.zeros((2, 512), dtype=torch.int64, device=dev)
    before = kernels.LAUNCHES["row_transform"]
    with pytest.raises(ValueError, match="periodic"):
        row_transform(Fr.p, Fr.n_prime, y, bad, True)
    assert kernels.LAUNCHES["row_transform"] == before


@pytest.mark.parametrize("nb,n", [(1, 64), (3, 4), (2, 1 << 11),
                                  (5, 1 << 18), (1, 1 << 18)])
def test_onepass_kernel_matches_plain(dev, nb, n):
    """Each call is one K6 launch, forward and mirror, and equals the
    plain five-step composition; the mirror undoes the forward."""
    from plonk_tpu_torch.ops import fused_ntt as FN
    w = SCALED_FR.root_of_unity(n)
    g = torch.Generator(device="cpu").manual_seed(n + nb)
    x = torch.randint(0, Fr.p, (nb, n), generator=g).to(dev)
    before = kernels.LAUNCHES["onepass_ntt"]
    y = FN.fused_ntt_1k(Fr, x, w)
    back = FN.fused_intt_1k(Fr, y, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["onepass_ntt"] == before + 2
    n1, n2 = FN._split(n)
    tables = (FN._row_tables(Fr, pow(w, n2, Fr.p), n1, dev),
              FN._tw_mat(Fr, w, n1, n2, False, True, dev),
              FN._row_tables(Fr, pow(w, n1, Fr.p), n2, dev))
    want = FN.onepass_plain(Fr.p, Fr.n_prime, x.reshape(nb, n1, n2),
                            *tables, False, None)
    assert torch.equal(y, want.reshape(nb, n))
    assert torch.equal(back, x)
    if n <= 1 << 11:
        assert torch.equal(y.cpu(), FN.fused_ntt(Fr, x.cpu(), w))


@pytest.mark.parametrize("fill", ["zeros", "p - 1"])
@pytest.mark.parametrize("nb,n", [(5, 1 << 18), (1, 1 << 18), (1, 2),
                                  (1, 8), (1, 64), (1, 1 << 11)])
def test_onepass_kernel_edge_inputs(dev, nb, n, fill):
    """Matrices of zeros and of p - 1, forward and scaled mirror, down to
    n1 = 1 (n = 2): word-equal to the plain version."""
    from plonk_tpu_torch.ops import fused_ntt as FN
    w = SCALED_FR.root_of_unity(n)
    n1, n2 = FN._split(n)
    y = torch.full((nb, n1, n2), 0 if fill == "zeros" else Fr.p - 1,
                   dtype=torch.int64, device=dev)
    for mirror in (False, True):
        args = (Fr.p, Fr.n_prime, y,
                *FN.onepass_tables(Fr, w, n, mirror, dev), mirror,
                Fr.const(pow(n, -1, Fr.p)) if mirror else None)
        before = kernels.LAUNCHES["onepass_ntt"]
        got = FN.onepass_ntt(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["onepass_ntt"] == before + 1
        assert torch.equal(got, FN.onepass_plain(*args))


@pytest.mark.parametrize("R,C,with_tw", [(24, 8, True), (40, 8, False),
                                         (2560, 512, True),
                                         (512, 512, False), (100, 32, True)])
def test_mont_matmul_kernel_matches_plain(dev, R, C, with_tw):
    from plonk_tpu_torch.ops import mxu_ntt as MX
    limbs = MX._limbs_on(Fr.p, SCALED_FR.root_of_unity(C), C, dev)
    g = torch.Generator(device="cpu").manual_seed(R * C)
    x = torch.randint(0, Fr.p, (R, C), generator=g).to(dev)
    T = C if R % C == 0 else R
    tw = (torch.randint(0, Fr.p, (T, C), generator=g).to(dev) if with_tw
          else None)
    before = kernels.LAUNCHES["mont_matmul"]
    got = MX.mont_matmul(Fr, x, MX.kmajor_limbs(limbs), tw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mont_matmul"] == before + 1
    assert torch.equal(got, MX._mont_mat_transform(Fr, x, limbs, tw))
    if R * C <= 4096:
        assert torch.equal(got.cpu(), MX._mont_mat_transform(
            Fr, x.cpu(), limbs.cpu(), None if tw is None else tw.cpu()))


@pytest.mark.parametrize("R,C,K", [(100, 8, 8), (70, 32, 45),
                                   (130, 512, 96), (72, 4096, 40),
                                   (65, 40, 33)])
def test_mont_matmul_kernel_tiles(dev, R, C, K):
    """K7 with R, K and C off its 64 x 32 tile and 32-byte chunk, random
    limb planes and a fused twiddle, through the K-major copy."""
    from plonk_tpu_torch.ops import mxu_ntt as MX
    g = torch.Generator(device="cpu").manual_seed(R + C + K)
    limbs = torch.randint(0, 128, (4, C, K), generator=g,
                          dtype=torch.int8).to(dev)
    x = torch.randint(0, Fr.p, (R, C), generator=g).to(dev)
    tw = torch.randint(0, Fr.p, (R, K), generator=g).to(dev)
    wk = MX.kmajor_limbs(limbs)
    before = kernels.LAUNCHES["mont_matmul"]
    got = MX.mont_matmul(Fr, x, wk, tw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mont_matmul"] == before + 1
    assert torch.equal(got, MX._mont_mat_transform(Fr, x, limbs, tw))


@pytest.mark.parametrize("R,C,K", [(5, 1, 3), (70, 33, 40)])
def test_mont_matmul_kernel_unaligned_rows(dev, R, C, K):
    """K7 where its X rows are not 16-byte aligned (C odd, or x one word
    into its storage), so it loads the words one by one."""
    from plonk_tpu_torch.ops import mxu_ntt as MX
    g = torch.Generator(device="cpu").manual_seed(R + C + K)
    limbs = torch.randint(0, 128, (4, C, K), generator=g,
                          dtype=torch.int8).to(dev)
    x = torch.randint(0, Fr.p, (R, C), generator=g).to(dev)
    shifted = torch.empty(R * C + 1, dtype=torch.int64,
                          device=dev)[1:].view(R, C)
    shifted.copy_(x)
    for xs in (x, shifted):
        before = kernels.LAUNCHES["mont_matmul"]
        got = MX.mont_matmul(Fr, xs, MX.kmajor_limbs(limbs))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mont_matmul"] == before + 1
        assert torch.equal(got, MX._mont_mat_transform(Fr, x, limbs))


@pytest.mark.parametrize("C", [8, 32, 512, 4096])
def test_mont_matmul_kernel_worst_buckets(dev, C):
    """K7's s32 buckets at their largest: every X word p - 1 against the
    DFT matrix's planes, and every limb 127 on both sides (X words
    2^28 - 1), which drives bucket k to min(k + 1, 7 - k, 4) * C * 127^2;
    the wrapper refuses C > 4096, and planes not in K-major form."""
    from plonk_tpu_torch.ops import mxu_ntt as MX
    R = 96
    limbs = MX._limbs_on(Fr.p, SCALED_FR.root_of_unity(C), C, dev)
    full = torch.full((4, C, C), 127, dtype=torch.int8, device=dev)
    for x, w in ((torch.full((R, C), Fr.p - 1, device=dev), limbs),
                 (torch.full((R, C), (1 << 28) - 1, device=dev), full)):
        before = kernels.LAUNCHES["mont_matmul"]
        got = MX.mont_matmul(Fr, x, MX.kmajor_limbs(w))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mont_matmul"] == before + 1
        assert torch.equal(got, MX._mont_mat_transform(Fr, x, w))
    with pytest.raises(ValueError):
        MX.mont_matmul(Fr, torch.zeros((64, 4097), dtype=torch.int64,
                                       device=dev),
                       MX.kmajor_limbs(torch.zeros((4, 4097, 32),
                                                   dtype=torch.int8,
                                                   device=dev)))
    with pytest.raises(TypeError):
        MX.mont_matmul(Fr, x, limbs)


@pytest.mark.parametrize("prims,kernel,per_proof",
                         [("fused", "row_transform", 4),
                          ("onepass", "onepass_ntt", 2),
                          ("mxu", "mont_matmul", 0),
                          ("mxu2", "mont_matmul", 4)])
def test_proof_under_prims_on_cuda_matches_cpu(dev, prims, kernel,
                                               per_proof):
    n = 16
    ch, rnd = [1111, 2222, 3333, 4444, 5555], list(range(1, 10))
    proofs = []
    for d in ("cpu", dev):
        ctx = PS.scaled_new(n, device=d)
        sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, n)
        prover = PS.make_prover(ctx, sel, cp,
                                prims=getattr(PS, f"{prims}_prims")())
        kernels.reset_counts()
        proof, diags = prover(a, b, c, ch, rnd)
        assert bool(diags.all_ok())
        if d != "cpu":
            assert kernels.LAUNCHES[kernel] == per_proof
            assert kernels.LAUNCHES["commit_many"] == 1
        proofs.append(proof)
    for name in POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(proofs[0], name)[k],
                               getattr(proofs[1], name)[k].cpu()), name
    for name in SCALAR_FIELDS:
        assert int(getattr(proofs[0], name)) == int(getattr(proofs[1],
                                                            name)), name
    assert int(proofs[1].r_z) == 91913729


# ---- BN254: K3 (16-limb row NTT) and K4 (16-limb fixed-base commit) ----

def _big_words(F, shape, seed):
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(32), "little") % F.p
                     for _ in range(int(np.prod(shape)))], dtype=object)
    return torch.as_tensor(F.encode_host(vals.reshape(shape)))


@pytest.mark.parametrize("R,C,dif,scaled", [(1280, 128, True, False),
                                            (128, 128, False, True),
                                            (5, 4, True, False),
                                            (3, 1024, False, True)])
def test_big_row_kernel_matches_plain(dev, R, C, dif, scaled):
    from plonk_tpu_torch.ops import bigntt as BN
    from plonk_tpu_torch.ops.bigfield import BigMontField
    from plonk_tpu_torch.utils.params import BN254_FR
    F = BigMontField(BN254_FR)
    w = BN254_FR.root_of_unity(C)
    y = _big_words(F, (R, C), R + C)
    scale = 12345 if scaled else None
    tw = torch.as_tensor(BN._row_tables(F, w, C))
    want = BN.big_row_pass_plain(
        F, y, tw, dif, None if scale is None else F.const(scale))
    before = kernels.LAUNCHES["big_row"]
    got = BN.big_row_pass(F, y.to(dev), w, dif, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_row"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("R,C,dif,scaled", [(1280, 128, True, False),
                                            (768, 128, True, False),
                                            (128, 128, False, True),
                                            (10, 4, False, False),
                                            (5, 2, True, True),
                                            (5, 1024, True, True)])
def test_big_row_kernel_edge_rows(dev, R, C, dif, scaled):
    """Rows of zeros, of p - 1, with lo = hi and with hi = p - lo (a lazy
    sum lands on p) beside random rows: word-equal to the plain version,
    whose outputs are canonical."""
    from plonk_tpu_torch.models.synthetic import big_edge_rows
    from plonk_tpu_torch.ops import bigntt as BN
    from plonk_tpu_torch.ops.bigfield import BigMontField
    from plonk_tpu_torch.utils.params import BN254_FR
    F = BigMontField(BN254_FR)
    w = BN254_FR.root_of_unity(C)
    y = torch.as_tensor(big_edge_rows(F.p, R, C, dif,
                                      np.random.default_rng(R + C)))
    scale = 54321 if scaled else None
    want = BN.big_row_pass_plain(
        F, y, torch.as_tensor(BN._row_tables(F, w, C)), dif,
        None if scale is None else F.const(scale))
    before = kernels.LAUNCHES["big_row"]
    got = BN.big_row_pass(F, y.to(dev), w, dif, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_row"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B,L", [(1, 40), (3, 40), (9, 40), (9, 1000)])
def test_big_commit_kernel_matches_plain(dev, B, L):
    """K4 on the packed table against its plain version: B = 1 and 9
    commitments, L not a multiple of any tile, an all-zero digit row, and
    repeated, opposite and infinity bases (every arm of the complete
    additions, the lazy residues' zero tests included)."""
    from plonk_tpu_torch.ops import bigcommit as BK
    from plonk_tpu_torch.ops import bigcurve as BC
    from plonk_tpu_torch.ops.bigfield import BigMontField
    from plonk_tpu_torch.utils.params import BN254_FR
    F = BigMontField(BC.BN254_FQ)
    rng = np.random.default_rng(5 + L)
    ks = [int(k) for k in rng.integers(1, 20, size=L)]
    order = BN254_FR.p
    ks[1::3] = [order - k for k in ks[1::3]]
    ks[4] = 0
    g = BC.bn254_generator(F, (L,), dev)
    bits = torch.as_tensor(np.stack([BC.scalar_to_bits(k, 254) for k in ks]))
    pts = BC.big_jac_mul(F, g, bits, 254)
    tbl = BC.build_big_table(F, pts, 4, 254)
    packed = BK.pack_commit_table(tbl)
    sc = rng.integers(0, 1 << 16, size=(B, L, 16))
    sc[..., 15] &= 0x1FFF                      # below 2^253 < r
    sc[0, ::5] = 0
    sc[-1] = 0                                 # an all-zero digit row
    if B > 2:
        sc[1] = sc[2]                          # equal rows, any order
    scalars = torch.as_tensor(sc, device=dev)
    before = kernels.LAUNCHES["big_commit"]
    got = BC.big_to_affine(F, BK.big_commit_many(F, tbl, scalars, packed))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_commit"] == before + 1
    want = BC.big_to_affine(F, BK.big_commit_many_plain(F, tbl, scalars))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2][-1])
    with pytest.raises(ValueError):
        BK.big_commit_many(F, tbl, scalars)    # K4 reads the packed table


def test_bn254_proof_on_cuda_matches_cpu(dev, monkeypatch, tmp_path):
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models.synthetic import bn254_mul_circuit, words_vec
    sel, cp, a, b, c = bn254_mul_circuit(8)
    ch = words_vec([111111, 222222, 333333, 444444, 555555])
    rnd = words_vec(range(17, 26))
    proofs = []
    for d in ("cpu", dev):
        # empty caches of the device's own: each builds its SRS and table
        bn254_env(monkeypatch, tmp_path / str(d))
        ctx = PB.bn254_setup(8, secret=987654321, device=d)
        prover = PB.make_prover_bn254(ctx, sel, cp)
        kernels.reset_counts()
        proof, diags = prover(a, b, c, ch, rnd)
        assert bool(diags.all_ok())
        if d != "cpu":
            assert kernels.LAUNCHES["big_row"] == 4
            assert kernels.LAUNCHES["big_commit"] == 1
        proofs.append(proof)
    for name in PB.POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(proofs[0], name)[k],
                               getattr(proofs[1], name)[k].cpu()), name
    for name in PB.SCALAR_FIELDS:
        assert torch.equal(getattr(proofs[0], name),
                           getattr(proofs[1], name).cpu()), name


def test_big_permute_on_cuda_matches_cpu(dev):
    """The 16-limb permutation of the BN254 transcript (t = 3) on a (4, 3)
    batch of seeded states, and a squeeze, give the CPU port's words."""
    from plonk_tpu_torch.ops.bigfield import BigMontField
    from plonk_tpu_torch.utils.params import BN254_FR
    F = BigMontField(BN254_FR)
    pos = PO.make_params(F.p, t=3)
    rng = np.random.default_rng(26)
    std = np.array([int.from_bytes(rng.bytes(32), "little") % F.p
                    for _ in range(12)], dtype=object).reshape(4, 3)
    x = F.array(std, "cpu")
    assert torch.equal(PO.big_permute(F, pos, x.to(dev)).cpu(),
                       PO.big_permute(F, pos, x))
    outs = [PO.big_squeeze(F, pos, x.to(d), pow_n_not_one=8)
            for d in (dev, "cpu")]
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kind", ["blake2b", "poseidon"])
def test_bn254_fs_proof_on_cuda_matches_cpu(dev, kind, monkeypatch,
                                            tmp_path):
    """The n = 8 BN254 FS proof on the card equals the CPU port's, nonce
    and challenge included, with K3 4 and K4 4 launches (one a round)."""
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models.synthetic import bn254_mul_circuit, words_vec
    sel, cp, a, b, c = bn254_mul_circuit(8)
    rnd = words_vec(range(17, 26))
    outs = []
    for d in ("cpu", dev):
        # empty caches of the device's own: each builds its SRS and table
        bn254_env(monkeypatch, tmp_path / str(d))
        ctx = PB.bn254_setup(8, secret=987654321, device=d)
        prover = (FS.BN254FsProver if kind == "blake2b"
                  else FSP.BN254PoseidonFsProver)(ctx, sel, cp)
        kernels.reset_counts()
        out, diags = prover.prove(a, b, c, rnd)
        assert bool(diags.all_ok())
        if d != "cpu":
            assert dict(kernels.LAUNCHES) == {"big_row": 4, "big_commit": 4}
        outs.append(out)
    assert outs[0].nonce == outs[1].nonce
    np.testing.assert_array_equal(outs[0].challenge, outs[1].challenge)
    for name in PB.POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(outs[0].proof, name)[k],
                               getattr(outs[1].proof, name)[k].cpu()), name
    for name in PB.SCALAR_FIELDS:
        assert torch.equal(getattr(outs[0].proof, name),
                           getattr(outs[1].proof, name).cpu()), name


# ---- K8 (all-gather) and K9 (all-to-all) over shards on one card ----

@pytest.mark.parametrize("D,shape", [(8, (1,)), (8, (3, 5)), (1, (7,)),
                                     (4, (64, 512)), (16, (2, 3)),
                                     (8, (64, 512)), (3, (5, 3)),
                                     (8, (1, 16)), (2, (1, 16))])
def test_all_gather_kernel_matches_plain(dev, D, shape):
    from plonk_tpu_torch.parallel import collectives as CL
    g = torch.Generator(device="cpu").manual_seed(D + len(shape))
    shards = [torch.randint(0, 1 << 62, shape, generator=g).to(dev)
              for _ in range(D)]
    before = kernels.LAUNCHES["all_gather"]
    got = CL.all_gather(shards, exchange="cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["all_gather"] == before + 1
    want = CL.all_gather(shards, exchange="plain")
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), torch.cat(shards).cpu())


# every exchange shape of the sharded 2^16 proof on 8 shards (chip_smoke.py
# dist_cases: the transposes of the 2^18 coset transforms and of the 2^16
# interpolations, both ways), then D = 1, odd rows, split == concat, two
# leading batch axes, 8-byte and 1-byte words
A2A_CASES = ([(8, lead + shape, len(lead) + sp, len(lead) + ct)
              for r, leads in ((512, ((5,), (10,), ())),
                               (256, ((9,), (3,), ())))
              for lead in leads
              for shape, sp, ct in (((r // 8, r), 1, 0),
                                    ((r, r // 8), 0, 1))]
             + [(1, (3, 7), 1, 0), (8, (3, 8, 5), 1, 2), (4, (3, 5, 4), 2, 1),
                (2, (6, 2), 1, 0), (8, (16, 24), 0, 0), (8, (3, 2, 8, 40), 2, 2),
                (8, (2, 3, 16, 64), 3, 2), (16, (2, 32, 3), 1, 2)])


@pytest.mark.parametrize("D,shape,split_axis,concat_axis", A2A_CASES)
def test_all_to_all_kernel_matches_plain(dev, D, shape, split_axis,
                                         concat_axis):
    """One K9 launch a call equals the plain all_to_all, in int64 words and
    in bytes (1-byte copy units)."""
    from plonk_tpu_torch.parallel import collectives as CL
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + D)
    for dtype in (torch.int64, torch.uint8):
        shards = [torch.randint(0, 1 << 62, shape, generator=g).to(dtype)
                  .to(dev) for _ in range(D)]
        before = kernels.LAUNCHES["all_to_all"]
        got = CL.all_to_all(shards, split_axis, concat_axis, exchange="cuda")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["all_to_all"] == before + 1
        want = CL.all_to_all_plain(shards, split_axis, concat_axis)
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape and torch.equal(a, b)


_ONE_KERNEL = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from plonk_tpu_torch.parallel import collectives as CL
cases = json.loads(sys.argv[1])
calls = []
for D, shape, split, concat in cases:
    xs = [torch.randint(0, 1 << 62, shape, device="cuda") for _ in range(D)]
    CL.all_to_all(xs, split, concat, "cuda")
    calls.append((xs, split, concat))
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for xs, split, concat in calls:
        CL.all_to_all(xs, split, concat, "cuda")
    torch.cuda.synchronize()
names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
print(json.dumps(names))
"""


def test_all_to_all_is_one_device_kernel(dev):
    """Each all_to_all call through K9 is one device kernel and nothing
    else (no copy before or after it): torch.profiler in a fresh process,
    whose first profiler session sees the library's launches, over one
    call at each shape of A2A_CASES."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cases = [c for c in A2A_CASES if c[0] == 8]
    res = subprocess.run([sys.executable, "-c", _ONE_KERNEL,
                          json.dumps(cases)], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    names = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(names) == len(cases), names
    assert all("all_to_all_kernel" in n for n in names), names


def test_collective_kernels_refuse_bad_shards(dev):
    from plonk_tpu_torch.parallel import collectives as CL
    src = [torch.arange(8, device=dev), torch.arange(8, 16, device=dev)]
    with pytest.raises(ValueError, match="overlaps"):
        CL.all_to_all_into(src, [src[1], torch.empty_like(src[0])], "cuda")
    with pytest.raises(ValueError, match="one device"):
        CL.all_gather_into(src, [torch.empty(16, dtype=torch.int64),
                                 torch.empty(16, dtype=torch.int64)], "cuda")
    before = kernels.LAUNCHES["all_to_all"]
    with pytest.raises(ValueError, match="one device"):
        CL.all_to_all([src[0], src[1].cpu()], 0, 0, "cuda")
    with pytest.raises(TypeError, match="dtype"):
        CL.all_to_all([src[0], src[1].int()], 0, 0, "cuda")
    with pytest.raises(ValueError, match="shape"):
        CL.all_to_all([src[0], src[1][:6]], 0, 0, "cuda")
    with pytest.raises(ValueError, match="1..16"):
        CL.all_to_all([src[0][:0]] * 17, 0, 0, "cuda")
    with pytest.raises(ValueError, match="divide"):
        CL.all_to_all([src[0][:3], src[1][:3]], 0, 0, "cuda")
    assert kernels.LAUNCHES["all_to_all"] == before


def test_sharded_proof_on_cuda_matches_cpu(dev):
    """n = 16 on 4 shards of the card, with K8/K9 and with plain copies:
    the CPU mesh's proof (and so JAX's, r_z = 91913729), launches
    counted."""
    from plonk_tpu_torch.parallel import dist_prover as DP
    from plonk_tpu_torch.parallel import mesh as MS
    n = 16
    ch, rnd = [1111, 2222, 3333, 4444, 5555], list(range(1, 10))
    proofs = []
    for d, exchange in (("cpu", None), (dev, "cuda"), (dev, "plain")):
        ctx = PS.scaled_new(n, device=d)
        sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, n)
        prims = DP.make_dist_prims(ctx, MS.make_1d_mesh("sp", 4, device=d),
                                   exchange=exchange)
        kernels.reset_counts()
        proof, diags = PS.prove_scaled(ctx, sel, cp, a, b, c, ch, rnd,
                                       prims=prims)
        assert bool(diags.all_ok())
        if exchange == "cuda":
            assert kernels.LAUNCHES["all_to_all"] == 15
            assert kernels.LAUNCHES["all_gather"] == 1
            assert kernels.LAUNCHES["commit_many"] == 4
        elif exchange == "plain":
            assert kernels.LAUNCHES["all_to_all"] == 0
            assert kernels.LAUNCHES["all_gather"] == 0
        proofs.append(proof)
    for proof in proofs[1:]:
        for name in POINT_FIELDS:
            for k in range(3):
                assert torch.equal(getattr(proofs[0], name)[k],
                                   getattr(proof, name)[k].cpu()), name
        for name in SCALAR_FIELDS:
            assert int(getattr(proofs[0], name)) == int(getattr(proof,
                                                                name)), name
    assert int(proofs[1].r_z) == 91913729


# ---- K8 on the prover's path: the sharded prefix product in one launch ----

def _scan_shards(dev, D: int, m: int, edge: bool, seed: int) -> list:
    from plonk_tpu_torch.models.synthetic import edge_scan_words
    rng = np.random.default_rng(seed)
    x = (edge_scan_words(Fr.p, D, m, rng) if edge
         else rng.integers(0, Fr.p, size=D * m))
    return [torch.as_tensor(c, device=dev) for c in np.split(x, D)]


def _assert_scan_equal(got, want):
    (outs, totals), (want_outs, want_totals) = got, want
    for a, b in zip(outs + totals, want_outs + want_totals, strict=True):
        assert torch.equal(a, b)
        assert bool(((a >= 0) & (a < Fr.p)).all())


@pytest.mark.parametrize("m", [1, 7, 8192, 65536])
@pytest.mark.parametrize("D", [1, 2, 8, 16])
def test_prefix_scan_kernel_matches_plain(dev, D, m):
    """dist_scan through K8's prefix-scan kernel equals the plain version
    word for word (scan, shifted form and gathered totals, all in [0, p)),
    on random words and on edge words (0, p - 1, 1, the Montgomery one, a
    zero total); one K8 launch a call."""
    from plonk_tpu_torch.parallel import dist_scan as DS
    from plonk_tpu_torch.parallel import mesh as MS
    mesh = MS.make_1d_mesh("sp", D, device=dev)
    for edge in (False, True):
        shards = _scan_shards(dev, D, m, edge, D * m)
        for shifted in (False, True):
            before = kernels.LAUNCHES["all_gather"]
            got = DS.dist_scan(Fr, mesh, shards, exchange="cuda",
                               shifted=shifted)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["all_gather"] == before + 1
            _assert_scan_equal(got, DS.dist_scan(Fr, mesh, shards,
                                                 exchange="plain",
                                                 shifted=shifted))


def test_prefix_scan_kernel_on_two_streams(dev):
    """Launches on two streams may overlap: each stream has its own ticket
    and flags, so both scans come out right."""
    from plonk_tpu_torch.parallel import dist_scan as DS
    from plonk_tpu_torch.parallel import mesh as MS
    mesh = MS.make_1d_mesh("sp", 8, device=dev)
    inputs = [_scan_shards(dev, 8, 8192, False, s) for s in range(2)]
    wants = [DS.dist_scan(Fr, mesh, x, exchange="plain") for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for _ in range(20):
        outs = []
        for st, x in zip(streams, inputs):
            with torch.cuda.stream(st):
                outs.append(DS.dist_scan(Fr, mesh, x, exchange="cuda"))
        torch.cuda.synchronize()
        for got, want in zip(outs, wants):
            _assert_scan_equal(got, want)


def test_prefix_scan_kernel_leaves_its_state_ready(dev):
    """200 launches in a row on one stream, with no host step between
    them, at D alternating between 8, 3 and 16: every launch finds its
    ticket ready (the last block moves it to the next epoch) and waits
    only for its own epoch's flags, never for those an earlier launch
    left."""
    from plonk_tpu_torch.parallel import dist_scan as DS
    from plonk_tpu_torch.parallel import mesh as MS
    cases = []
    for D in (8, 3, 16):
        mesh = MS.make_1d_mesh("sp", D, device=dev)
        x = _scan_shards(dev, D, 1000, D == 3, D)
        cases.append((mesh, x, DS.dist_scan(Fr, mesh, x, exchange="plain",
                                            shifted=D == 16)))
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["all_gather"]
    got = [DS.dist_scan(Fr, mesh, x, exchange="cuda",
                        shifted=len(x) == 16)
           for k in range(200) for mesh, x, _ in [cases[k % 3]]]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["all_gather"] == before + 200
    for k, g in enumerate(got):
        _assert_scan_equal(g, cases[k % 3][2])


_ONE_SCAN = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.parallel import dist_scan as DS
from plonk_tpu_torch.parallel import mesh as MS
from plonk_tpu_torch.utils.params import SCALED_FR
F = MontField(SCALED_FR)
mesh = MS.make_1d_mesh("sp", 8)
xs = [torch.randint(0, F.p, (8192,), device="cuda") for _ in range(8)]
for fn in (DS.dist_prefix_prod, DS.dist_grand_product):
    fn(F, mesh, xs)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for fn in (DS.dist_prefix_prod, DS.dist_grand_product):
        fn(F, mesh, xs)
    torch.cuda.synchronize()
names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
print(json.dumps(names))
"""


def test_prefix_scan_is_one_device_kernel(dev):
    """dist_prefix_prod and dist_grand_product on a CUDA mesh are one
    device kernel each and nothing else (no PyTorch field launch, no copy
    around it): torch.profiler in a fresh process, whose first profiling
    run records the library's launches."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _ONE_SCAN], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    names = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(names) == 2, names
    assert all("prefix_scan_kernel" in n for n in names), names


def test_prefix_scan_refuses_bad_shards(dev):
    from plonk_tpu_torch.parallel import collectives as CL
    x = torch.ones(8, dtype=torch.int64, device=dev)
    before = kernels.LAUNCHES["all_gather"]
    args = (Fr.p, Fr.n_prime, Fr.r_mod_p)
    with pytest.raises(ValueError, match="one device"):
        CL.prefix_scan([x, x.cpu()], *args)
    with pytest.raises(TypeError, match="int64"):
        CL.prefix_scan([x, x.int()], *args)
    with pytest.raises(ValueError, match="one length"):
        CL.prefix_scan([x, x[:4]], *args)
    with pytest.raises(ValueError, match="one length"):
        CL.prefix_scan([x[:0], x[:0]], *args)
    with pytest.raises(ValueError, match="contiguous"):
        CL.prefix_scan([x[::2], x[1::2]], *args)
    assert kernels.LAUNCHES["all_gather"] == before


def _toy_lanes(B: int, seed: int):
    from plonk_tpu_torch.models.presets import (CANONICAL_CHALLENGE,
                                                CANONICAL_RAND,
                                                canonical_assignments)
    rng = np.random.default_rng(seed)
    chs = rng.integers(0, 17, size=(B, 5))
    rnds = rng.integers(0, 17, size=(B, 9))
    chs[0], rnds[0] = CANONICAL_CHALLENGE, CANONICAL_RAND
    asg = canonical_assignments()
    return [np.tile(w, (B, 1)) for w in (asg.a, asg.b, asg.c)] + [chs, rnds]


def _same_words(p, q) -> None:
    """Word equality of two (batched) proofs or diagnostics."""
    for u, v in zip(p, q):
        if isinstance(u, tuple):
            _same_words(u, v)
        else:
            assert torch.equal(u.cpu(), v.cpu())


@pytest.mark.parametrize("mode", ["naive", "table", "pippenger"])
def test_toy_proof_on_cuda_matches_cpu(dev, mode):
    """The toy canonical proof on the card: the reference SRS and dialect
    give the golden proof, the fixed SRS and the standard dialect verify;
    both equal the CPU port's words, and no kernel of K1-K9 launches."""
    from plonk_tpu_torch.models import plonk as PL
    from plonk_tpu_torch.models import verifier as TV
    from plonk_tpu_torch.models.presets import (
        CANONICAL_CHALLENGE, CANONICAL_RAND, canonical_assignments,
        canonical_constraints, canonical_context)
    kw = {"naive": {}, "table": {"commit_mode": "table"},
          "pippenger": {"use_pippenger": True}}[mode]
    cons, asg = canonical_constraints(), canonical_assignments()
    kernels.reset_counts()
    for srs_mode, dialect in (("reference", "reference"),
                              ("fixed", "standard")):
        out = [PL.prove(canonical_context(srs_mode, device=d, **kw), cons,
                        asg, CANONICAL_CHALLENGE, CANONICAL_RAND,
                        dialect=dialect) for d in ("cpu", dev)]
        _same_words(out[0], out[1])
        proof, diags = out[1]
        assert proof.r_z.device.type == "cuda" and bool(diags.all_ok())
    ref = out[0]
    assert int(proof.r_z) == int(ref[0].r_z)
    ctx = canonical_context("fixed", device=dev, **kw)
    vk = TV.make_verification_key(ctx, cons)
    assert TV.verify(ctx, vk, proof, CANONICAL_CHALLENGE)
    assert not TV.verify(ctx, vk, proof._replace(r_z=(proof.r_z + 1) % 17),
                         CANONICAL_CHALLENGE)
    assert not dict(kernels.LAUNCHES)


def test_toy_batch_on_cuda_matches_cpu(dev):
    """A batch of 1024 toy proofs (fixed SRS, reference dialect, seeded
    challenges and blinding) on the card equals the CPU port's batch and
    the card's 8-shard prover, diagnostics included."""
    from plonk_tpu_torch.models.constraints import constraints_to_tensors
    from plonk_tpu_torch.models.presets import (canonical_constraints,
                                                canonical_context)
    from plonk_tpu_torch.parallel import batch as TB
    from plonk_tpu_torch.parallel.mesh import make_1d_mesh
    sel, cp = constraints_to_tensors(canonical_constraints())
    args = _toy_lanes(1024, 7)
    out = [TB.make_batched_prover(canonical_context("fixed", device=d), sel,
                                  cp)(*args) for d in ("cpu", dev)]
    _same_words(out[0], out[1])
    assert out[1][0].r_z.shape == (1024,) and int(out[1][0].r_z[0]) == 15
    ctx = canonical_context("fixed", device=dev)
    sharded = TB.make_sharded_prover(ctx, sel, cp,
                                     make_1d_mesh("dp", 8, device=dev))(*args)
    _same_words(sharded, out[1])


# ---- batched proving: one pass for B proofs, one proof's launches ----

def _leaves(proof) -> list:
    """The tensors of a proof of either curve, points' words first."""
    return [t for f in proof
            for t in (f if isinstance(f, tuple) else (f,))]


def _lane_equal(batch, single, i: int) -> bool:
    """Lane i of a stacked proof equals `single`, word for word."""
    return all(torch.equal(x[i].cpu(), y.cpu())
               for x, y in zip(_leaves(batch), _leaves(single)))


def _same_proofs(p, q) -> bool:
    """Two proofs (or stacked batches) of either curve equal word for
    word."""
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(_leaves(p), _leaves(q)))


def _scaled_batch(n: int, B: int):
    """Inputs of B scaled proofs: witnesses x0 = 3 + i, lane 1's c[5] off
    by one (a wrong witness), blinding 1..9 + 100 i."""
    p = SCALED_FR.p
    sel, cp = square_chain_circuit(p, n)[:2]
    wits = [square_chain_circuit(p, n, x0=3 + i)[2:] for i in range(B)]
    a, b, c = (np.stack([w[k] for w in wits]).astype(np.int64)
               for k in range(3))
    c[1, 5] = (c[1, 5] + 1) % p
    chs = np.tile(np.array([1111, 2222, 3333, 4444, 5555]), (B, 1))
    rnds = (np.arange(1, 10) + 100 * np.arange(B)[:, None]) % p
    return sel, cp, (a, b, c, chs, rnds)


def test_batched_proof_on_cuda_matches_cpu(dev):
    """B = 3 scaled proofs at n = 16 (one wrong witness): the card's batch
    equals the CPU port's word for word, diagnostics per lane included."""
    sel, cp, args = _scaled_batch(16, 3)
    outs = []
    for d in ("cpu", dev):
        ctx = PS.scaled_new(16, device=d)
        outs.append(PS.make_prover(ctx, sel, cp)(*args))
    (p_cpu, d_cpu), (p_gpu, d_gpu) = outs
    assert _same_proofs(p_cpu, p_gpu)
    for f, g in zip(d_cpu, d_gpu):
        assert torch.equal(f, g.cpu())
    assert d_gpu.satisfied.tolist() == [True, False, True]


def test_batched_launches_equal_one_proof(dev):
    """At n = 4096 (K1's blocked layout) a batch of 2 launches K1 and K2
    as often as one proof, and its lanes equal the single proofs."""
    sel, cp, args = _scaled_batch(4096, 2)
    prover = PS.make_prover(PS.scaled_new(4096, device=dev), sel, cp)
    kernels.reset_counts()
    single = [prover(*(x[i] for x in args)) for i in range(2)]
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"row_stages": 8, "commit_many": 2}
    kernels.reset_counts()
    proof, diags = prover(*args)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"row_stages": 4, "commit_many": 1}
    assert diags.satisfied.tolist() == [True, False]
    for i, (one, d) in enumerate(single):
        assert _lane_equal(proof, one, i)
        assert bool(d.satisfied) == bool(diags.satisfied[i])


def test_batched_bn254_proof_on_cuda_matches_cpu(dev, monkeypatch,
                                                 tmp_path):
    """B = 2 BN254 proofs at n = 8: the card's batch equals the CPU port's
    word for word and each single proof, with one proof's launches (K3 4,
    K4 1)."""
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models.synthetic import bn254_mul_circuit, words_vec
    circuits = [bn254_mul_circuit(8, seed=11 + i) for i in range(2)]
    sel, cp = circuits[0][:2]
    a, b, c = (np.stack([ci[2 + k] for ci in circuits]) for k in range(3))
    chs = np.stack([words_vec([111111, 222222, 333333, 444444, 555555]),
                    words_vec([666666, 777777, 888888, 999999, 1234567])])
    rnds = np.stack([words_vec(range(17, 26)), words_vec(range(31, 40))])
    outs = []
    for d in ("cpu", dev):
        # empty caches of the device's own: each builds its SRS and table
        bn254_env(monkeypatch, tmp_path / str(d))
        ctx = PB.bn254_setup(8, secret=987654321, device=d)
        prover = PB.make_prover_bn254(ctx, sel, cp)
        kernels.reset_counts()
        proof, diags = prover(a, b, c, chs, rnds)
        assert bool(diags.all_ok()) and diags.satisfied.shape == (2,)
        if d != "cpu":
            assert dict(kernels.LAUNCHES) == {"big_row": 4, "big_commit": 1}
            single = [prover(a[i], b[i], c[i], chs[i], rnds[i])[0]
                      for i in range(2)]
        outs.append(proof)
    assert _same_proofs(outs[0], outs[1])
    for i in range(2):
        assert _lane_equal(outs[1], single[i], i)


def test_commit_kernel_batched_rows_with_zero_lane(dev):
    """K2 at a batch's B * 9 rows (B = 16, L = 4 101, more rows than SMs:
    one tile a commitment) with one all-zero lane, against its plain
    version."""
    rng = np.random.default_rng(144)
    r = SCALED_CURVE.r
    L = 4101
    tbl = CM.build_commit_table(Fq, _commit_points(rng, L), r.bit_length())
    sc = rng.integers(0, r, size=(144, L))
    sc[27:36] = 0
    scalars = torch.as_tensor(sc, device=dev)
    before = kernels.LAUNCHES["commit_many"]
    got = CM.msm_fixed_base_many_kernel(Fq, tbl, scalars)
    assert kernels.LAUNCHES["commit_many"] == before + 1
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    _assert_affine_equal(got, want)
    assert bool(got.inf[27:36].all())


def test_big_commit_kernel_batched_rows_with_zero_lane(dev):
    """K4 at a batch's B * 9 rows (B = 4: 36) with one all-zero lane,
    against its plain version."""
    from plonk_tpu_torch.ops import bigcommit as BK
    from plonk_tpu_torch.ops import bigcurve as BC
    from plonk_tpu_torch.ops.bigfield import BigMontField
    F = BigMontField(BC.BN254_FQ)
    L = 300
    rng = np.random.default_rng(36)
    ks = [int(k) for k in rng.integers(1, 20, size=L)]
    g = BC.bn254_generator(F, (L,), dev)
    bits = torch.as_tensor(np.stack([BC.scalar_to_bits(k, 254) for k in ks]))
    tbl = BC.build_big_table(F, BC.big_jac_mul(F, g, bits, 254), 4, 254)
    sc = rng.integers(0, 1 << 16, size=(36, L, 16))
    sc[..., 15] &= 0x1FFF
    sc[9:18] = 0
    scalars = torch.as_tensor(sc, device=dev)
    before = kernels.LAUNCHES["big_commit"]
    got = BC.big_to_affine(F, BK.big_commit_many(
        F, tbl, scalars, BK.pack_commit_table(tbl)))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_commit"] == before + 1
    want = BC.big_to_affine(F, BK.big_commit_many_plain(F, tbl, scalars))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert bool(got[2][9:18].all()) and not bool(got[2][:9].any())


# ---- BN254 MSMs without a table: Pippenger and GLV ----

def _msm_inputs(dev, L, B, seed):
    """Seeded multiples of G (one at infinity, one repeated, one the
    negative of another; made by the python-int oracle) and B lanes of
    scalars below r (zeros in lane 0, lane B - 1 all zero): (field, points,
    scalars on the CPU, the same on `dev`)."""
    import bn254_oracle as O
    from plonk_tpu_torch.ops import bigcurve as BC
    from plonk_tpu_torch.ops.bigfield import BigMontField
    F = BigMontField(BC.BN254_FQ)
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 20, size=L)]
    ks[3], ks[5], ks[7] = 0, ks[4], O.R - ks[6]
    aff = [O.g1_mul(O.G1_GEN, k) if k else None for k in ks]
    xy = [F.array([p[i] if p else 0 for p in aff], "cpu") for i in (0, 1)]
    pts = BC.affine_to_jac(F, *xy, torch.tensor([p is None for p in aff]))
    sc = rng.integers(0, 1 << 16, size=(B, L, 16))
    sc[..., 15] &= 0x0FFF
    sc[0, ::3] = 0
    sc[-1] = 0
    sc = torch.as_tensor(sc)
    return F, pts, sc, BC.BigG1J(*(c.to(dev) for c in pts)), sc.to(dev)


@pytest.mark.parametrize("kind", ["pippenger", "glv"])
@pytest.mark.parametrize("L,B", [(13, 2), (100, 2)])
def test_msm_on_cuda_matches_cpu(dev, kind, L, B):
    """big_msm_pippenger_many and big_msm_glv_many on the card give the
    CPU port's affine words (no kernel: PyTorch ops on the card), the
    single forms lane 0's."""
    from plonk_tpu_torch.ops import bigcurve as BC
    from plonk_tpu_torch.ops import glv as GLV
    F, pts, sc, pts_d, sc_d = _msm_inputs(dev, L, B, L)
    many = {"pippenger": BC.big_msm_pippenger_many,
            "glv": GLV.big_msm_glv_many}[kind]
    one = {"pippenger": BC.big_msm_pippenger, "glv": GLV.big_msm_glv}[kind]
    kernels.reset_counts()
    got = BC.big_to_affine(F, many(F, pts_d, sc_d))
    single = BC.big_to_affine(F, BC.BigG1J(
        *(c[None] for c in one(F, pts_d, sc_d[0]))))
    torch.cuda.synchronize()
    assert not kernels.LAUNCHES
    want = BC.big_to_affine(F, many(F, pts, sc))
    for a, b, s in zip(got, want, single):
        assert torch.equal(a.cpu(), b) and torch.equal(s.cpu(), b[:1])
    assert bool(want[2][-1]) and not bool(want[2][0])


def test_glv_decompose_on_cuda_matches_cpu(dev):
    from plonk_tpu_torch.ops import glv as GLV
    rng = np.random.default_rng(11)
    sw = torch.as_tensor(rng.integers(0, 1 << 16, size=(64, 16)))
    sw[:, 15] &= 0x0FFF
    sw[0] = 0
    for a, b in zip(GLV.glv_decompose(sw.to(dev)), GLV.glv_decompose(sw)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("wb", [3, 5, 8])
def test_big_commit_kernel_other_window_bits(dev, wb):
    """K4 reads the window width from the table: 3-, 5- (digits across
    two words) and 8-bit tables against the plain version."""
    from plonk_tpu_torch.ops import bigcommit as BK
    from plonk_tpu_torch.ops import bigcurve as BC
    F, pts, sc, pts_d, sc_d = _msm_inputs(dev, 40, 3, wb)
    tbl = BC.build_big_table(F, pts_d, wb, 254)
    got = BC.big_to_affine(F, BK.big_commit_many(
        F, tbl, sc_d, BK.pack_commit_table(tbl)))
    want = BC.big_to_affine(F, BK.big_commit_many_plain(F, tbl, sc_d))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fb", ["1", "0"])
def test_bn254_commit_routes_on_cuda_match_cpu(dev, fb, monkeypatch,
                                               tmp_path):
    """The n = 8 proof under PLONK_TPU_BN254_FB=1 (K4) and =0 (GLV, no K4)
    on the card equals the CPU port's; K3 4 launches either way."""
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models.synthetic import bn254_mul_circuit, words_vec
    monkeypatch.setenv("PLONK_TPU_BN254_FB", fb)
    sel, cp, a, b, c = bn254_mul_circuit(8)
    ch = words_vec([111111, 222222, 333333, 444444, 555555])
    rnd = words_vec(range(17, 26))
    proofs = []
    for d in ("cpu", dev):
        # empty caches of the device's own: each builds its SRS and table
        bn254_env(monkeypatch, tmp_path / str(d), table_route=False)
        ctx = PB.bn254_setup(8, secret=987654321, device=d)
        prover = PB.make_prover_bn254(ctx, sel, cp)
        kernels.reset_counts()
        proof, diags = prover(a, b, c, ch, rnd)
        assert bool(diags.all_ok())
        if d != "cpu":
            assert dict(kernels.LAUNCHES) == (
                {"big_row": 4, "big_commit": 1} if fb == "1"
                else {"big_row": 4})
        proofs.append(proof)
    for name in PB.POINT_FIELDS:
        for k in range(3):
            assert torch.equal(getattr(proofs[0], name)[k],
                               getattr(proofs[1], name)[k].cpu()), name


# ---- the mesh-sharded BN254 prover (parallel/dist_bigntt, dist_bn254) ----

def _bn_dist_a2a_cases():
    """(D, shard shape, split, concat) of every 16-limb all-to-all of the
    sharded n = 8 proof on 2 shards and of the 2^12 proof on 8, their
    precompute included (interpolation batches 9, 4, none; coset batches
    10, 6, none), and at a batch of 12."""
    from plonk_tpu_torch.parallel.dist_ntt import _split
    cases = []
    for n, D in ((8, 2), (1 << 12, 8)):
        for size, batches in ((n, (9, 4, 12, None)),
                              (4 * n, (10, 6, 12, None))):
            n1, n2 = _split(size, D)
            for b in batches:
                lead = () if b is None else (b,)
                k = len(lead)
                cases += [(D, lead + (n1 // D, n2, 16), k + 1, k),
                          (D, lead + (n1, n2 // D, 16), k, k + 1)]
    return cases


@pytest.mark.parametrize("D,shape,split_axis,concat_axis",
                         _bn_dist_a2a_cases())
def test_all_to_all_kernel_at_the_limb_shapes(dev, D, shape, split_axis,
                                              concat_axis):
    """K9 with the trailing 16-word axis: one launch a call, the plain
    all_to_all's words."""
    from plonk_tpu_torch.parallel import collectives as CL
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + D)
    shards = [torch.randint(0, 1 << 16, shape, generator=g).to(dev)
              for _ in range(D)]
    before = kernels.LAUNCHES["all_to_all"]
    got = CL.all_to_all(shards, split_axis, concat_axis, exchange="cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["all_to_all"] == before + 1
    want = CL.all_to_all_plain(shards, split_axis, concat_axis)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("R,C", [(256, 64), (64, 64), (768, 128),
                                 (128, 128), (4, 2), (6, 8), (3, 1024)])
def test_sharded_local_transform_matches_big_ntt(dev, R, C):
    """The sharded transforms' local transform on the card (one K3 row
    pass, then the bit-reversal gather) gives big_ntt's words, on random
    and edge rows, forward and inverse roots."""
    from plonk_tpu_torch.models.synthetic import big_edge_rows
    from plonk_tpu_torch.ops.bigfield import BigMontField, big_ntt
    from plonk_tpu_torch.parallel import dist_bigntt as DBN
    from plonk_tpu_torch.utils.params import BN254_FR
    F = BigMontField(BN254_FR)
    w = BN254_FR.root_of_unity(C)
    rng = np.random.default_rng(R + C)
    for y, root in ((_big_words(F, (R, C), R + C), w),
                    (torch.as_tensor(big_edge_rows(F.p, R, C, True, rng)),
                     pow(w, -1, F.p))):
        before = kernels.LAUNCHES["big_row"]
        got = DBN._row_ntt(F, y.to(dev), root)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["big_row"] == before + 1
        assert torch.equal(got.cpu(), big_ntt(F, y, root))


def test_bn254_sharded_proof_on_cuda_matches_cpu(dev, monkeypatch,
                                                 tmp_path):
    """The n = 8 proof under make_dist_bn254_prims on 2 shards of the card
    equals the CPU mesh's, each device building its SRS and table under
    empty caches of its own; on the card, the table route launches K3 8,
    K9 10, K8 1 and K4 2 times, PLONK_TPU_BN254_FB=0 no K4, plain
    exchanges no K8 or K9."""
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models.synthetic import bn254_mul_circuit, words_vec
    from plonk_tpu_torch.parallel import dist_bn254 as DB
    from plonk_tpu_torch.parallel import mesh as MS
    sel, cp, a, b, c = bn254_mul_circuit(8)
    ch = words_vec([111111, 222222, 333333, 444444, 555555])
    rnd = words_vec(range(17, 26))
    table = {"big_row": 8, "all_to_all": 10, "all_gather": 1,
             "big_commit": 2}
    runs = [("cpu", None, "1", None), (dev, None, "1", table),
            (dev, "plain", "1", {"big_row": 8, "big_commit": 2}),
            (dev, None, "0", {"big_row": 8, "all_to_all": 10,
                              "all_gather": 1})]
    proofs, ctxs = [], {}
    for d, exchange, fb, launches in runs:
        if d not in ctxs:
            # empty caches of the device's own: each builds its SRS and table
            bn254_env(monkeypatch, tmp_path / str(d))
            ctxs[d] = PB.bn254_setup(8, secret=987654321, device=d)
        monkeypatch.setenv("PLONK_TPU_BN254_FB", fb)
        prims = DB.make_dist_bn254_prims(
            ctxs[d], MS.make_1d_mesh("sp", 2, device=d), exchange=exchange)
        prover = PB.make_prover_bn254(ctxs[d], sel, cp, prims=prims)
        kernels.reset_counts()
        proof, diags = prover(a, b, c, ch, rnd)
        assert bool(diags.all_ok())
        if launches is not None:
            torch.cuda.synchronize()
            assert dict(kernels.LAUNCHES) == launches
        proofs.append(proof)
    for proof in proofs[1:]:
        for name in PB.POINT_FIELDS:
            for k in range(3):
                assert torch.equal(getattr(proofs[0], name)[k],
                                   getattr(proof, name)[k].cpu()), name
        for name in PB.SCALAR_FIELDS:
            assert torch.equal(getattr(proofs[0], name),
                               getattr(proof, name).cpu()), name


@pytest.mark.parametrize("exchange,launches", [
    (None, {"all_gather": 1}), ("plain", {})])
def test_dist_msm_on_cuda_matches_cpu(dev, exchange, launches):
    """dist_msm of 2^12 toy points (bench_msm's draw, default_rng(1), 5-bit
    windows and scalars) on 8 shards of the card equals the CPU port's and
    the card's single-device msm_pippenger; through K8 the partials'
    gather is one launch, under the plain exchange none."""
    from plonk_tpu_torch.ops.field import Field
    from plonk_tpu_torch.ops.msm import msm_pippenger
    from plonk_tpu_torch.parallel import mesh as MS
    from plonk_tpu_torch.parallel.dist_msm import dist_msm
    from plonk_tpu_torch.utils.params import GF101, TOY_CURVE
    F = Field(GF101)
    rng = np.random.default_rng(1)
    ks = rng.integers(1, 17, size=1 << 12)
    sc = rng.integers(0, 17, size=1 << 12)
    outs = []
    for d in ("cpu", dev):
        pts = C.g1_mul(F, C.g1_generator(TOY_CURVE, F, d),
                       torch.as_tensor(ks, device=d), nbits=5)
        mesh = MS.make_1d_mesh("sp", 8, device=d)
        kernels.reset_counts()
        got = dist_msm(F, mesh, pts, sc, window_bits=5, scalar_bits=5,
                       exchange=exchange if d != "cpu" else None)
        torch.cuda.synchronize()
        if d != "cpu":
            assert dict(kernels.LAUNCHES) == launches
            assert got.x.device == mesh.device
            single = msm_pippenger(F, pts, torch.as_tensor(sc, device=d),
                                   window_bits=5, scalar_bits=5)
            outs.append(tuple(int(c) for c in single))
        outs.append(tuple(int(c) for c in got))
    assert outs[0] == outs[1] == outs[2]


def test_entry_on_cuda_matches_cpu(dev):
    """The port's entry() on the card: r_z = 15, every output word equal to
    the CPU port's, no kernel launched."""
    from plonk_tpu_torch import entry as E
    out = []
    for d in ("cpu", dev):
        fn, args = E.entry(device=d)
        kernels.reset_counts()
        out.append(fn(*args))
        assert not dict(kernels.LAUNCHES)
    assert int(out[1][0].r_z) == 15 and out[1][0].r_z.device.type == "cuda"
    _same_words(out[0], out[1])
