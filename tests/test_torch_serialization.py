"""The port's proof and SRS bytes (plonk_tpu_torch.utils.serialization)
against the JAX package's (plonk_tpu.utils.serialization): the bytes are
equal, and each package loads the bytes the other wrote, for a scaled
proof at n = 8, the toy canonical proof, the scaled SRS and a BN254 n = 8
proof (the JAX values recorded in tests/test_torch_bn254.py)."""
import numpy as np
import pytest
import torch

from plonk_tpu.models.srs import SRS as JSRS
from plonk_tpu.utils import serialization as JSZ
from plonk_tpu_torch.models import plonk_bn254 as PB
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.presets import (CANONICAL_CHALLENGE,
                                            CANONICAL_RAND,
                                            canonical_assignments,
                                            canonical_constraints,
                                            canonical_context)
from plonk_tpu_torch.models import plonk as PL
from plonk_tpu_torch.models.synthetic import square_chain_circuit, words_vec
from plonk_tpu_torch.ops.curve import G1, G2
from plonk_tpu_torch.utils import convert
from plonk_tpu_torch.utils import serialization as SZ
from test_torch_bn254 import JAX_POINTS, JAX_SCALARS

N = 8


@pytest.fixture(scope="module")
def scaled():
    ctx = PS.scaled_new(N, device="cpu")
    sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, N)
    proof, diags = PS.make_prover(ctx, sel, cp)(
        a, b, c, [1111, 2222, 3333, 4444, 5555], list(range(1, 10)))
    assert bool(diags.all_ok())
    return ctx, proof


def _moduli(ctx):
    return ctx.params.curve.base.p, ctx.params.field.p


def _words(v) -> np.ndarray:
    return np.asarray(v).astype(np.int64)


def assert_proof_equal(got, want, fields=(POINT_FIELDS, SCALAR_FIELDS)):
    """Proofs of either package (or numpy), by words and flags."""
    for name in fields[0]:
        g, w = getattr(got, name), getattr(want, name)
        for k in range(3):
            np.testing.assert_array_equal(_words(g[k]), _words(w[k]), name)
    for name in fields[1]:
        np.testing.assert_array_equal(_words(getattr(got, name)),
                                      _words(getattr(want, name)), name)


def test_scaled_proof_bytes_cross_load(scaled):
    ctx, proof = scaled
    data = SZ.proof_to_bytes(proof, *_moduli(ctx))
    assert data == JSZ.proof_to_bytes(convert.proof_to_numpy(proof),
                                      *_moduli(ctx))
    assert len(data) == 8 + 9 * (2 * 4 + 1) + 7 * 4
    assert_proof_equal(JSZ.proof_from_bytes(data), proof)
    back = SZ.proof_from_bytes(data, "cpu")
    assert_proof_equal(back, proof)
    assert back.a_s.x.dtype == torch.int64 and back.a_s.inf.dtype == \
        torch.bool and back.r_z.shape == ()


def test_toy_proof_bytes_cross_load():
    ctx = canonical_context(device="cpu")
    proof, _ = PL.prove(ctx, canonical_constraints(),
                        canonical_assignments(), CANONICAL_CHALLENGE,
                        CANONICAL_RAND)
    data = SZ.proof_to_bytes(proof, 101, 17)
    assert data == JSZ.proof_to_bytes(convert.proof_to_numpy(proof), 101, 17)
    assert len(data) == 8 + 9 * 3 + 7
    assert_proof_equal(SZ.proof_from_bytes(data, "cpu"), proof)
    assert int(SZ.proof_from_bytes(data, "cpu").r_z) == 15


def test_srs_bytes_cross_load(scaled):
    ctx, _ = scaled
    srs = ctx.srs
    data = SZ.srs_to_bytes(srs, ctx.params.curve.base.p)
    d = convert.srs_to_numpy(srs)
    jsrs = JSRS(g1s=G1(d["g1_x"], d["g1_y"], d["g1_inf"]),
                g2_1=G2(*d["g2_1"]), g2_s=G2(*d["g2_s"]), mode=d["mode"])
    assert data == JSZ.srs_to_bytes(jsrs, ctx.params.curve.base.p)
    assert len(data) == 16 + srs.length * 9 + 2 * 8
    for got in (JSZ.srs_from_bytes(data, mode="fixed"),
                SZ.srs_from_bytes(data, mode="fixed", device="cpu")):
        assert got.mode == "fixed" and got.length == srs.length
        for a, b in zip(tuple(got.g1s) + tuple(got.g2_1) + tuple(got.g2_s),
                        tuple(srs.g1s) + tuple(srs.g2_1) + tuple(srs.g2_s)):
            np.testing.assert_array_equal(_words(a), _words(b))


def _bn254_proof() -> PB.BN254Proof:
    """The JAX BN254 n = 8 proof of tests/test_torch_bn254.py, as the port's
    BN254Proof of standard-form words."""
    t = lambda v: torch.as_tensor(words_vec([v])[0].astype(np.int64))
    fields = {name: PB.BigG1Affine(t(x), t(y), torch.tensor(False))
              for name, (x, y) in JAX_POINTS.items()}
    fields.update({name: t(v) for name, v in JAX_SCALARS.items()})
    return PB.BN254Proof(**fields)


def test_bn254_proof_bytes_cross_load():
    proof = _bn254_proof()
    data = SZ.bn254_proof_to_bytes(proof)
    assert data == JSZ.bn254_proof_to_bytes(convert.bn254_proof_to_numpy(
        proof))
    assert len(data) == 8 + 9 * 65 + 7 * 32
    assert int.from_bytes(data[8 + 9 * 65 + 5 * 32:][:32], "little") == \
        JAX_SCALARS["r_z"]
    fields = (PB.POINT_FIELDS, PB.SCALAR_FIELDS)
    assert_proof_equal(JSZ.bn254_proof_from_bytes(data), proof, fields)
    back = SZ.bn254_proof_from_bytes(data, "cpu")
    assert_proof_equal(back, proof, fields)
    assert back.a_s.x.shape == (16,)


def test_loaders_refuse_bad_bytes(scaled):
    ctx, proof = scaled
    data = SZ.proof_to_bytes(proof, *_moduli(ctx))
    srs = SZ.srs_to_bytes(ctx.srs, ctx.params.curve.base.p)
    for load, bad, match in (
            (SZ.proof_from_bytes, b"XPLK" + data[4:], "magic"),
            (SZ.proof_from_bytes, data + b"\0", "trailing"),
            (SZ.proof_from_bytes, data[:-1], "truncated"),
            (SZ.proof_from_bytes, data[:4] + b"\2" + data[5:], "version"),
            (SZ.srs_from_bytes, srs[:-3], "truncated"),
            (SZ.bn254_proof_from_bytes, data, "magic")):
        with pytest.raises(ValueError, match=match):
            load(bad, device="cpu")


def test_loaders_default_to_the_card(scaled):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    ctx, proof = scaled
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SZ.proof_from_bytes(SZ.proof_to_bytes(proof, *_moduli(ctx)))
