"""The port's BN254 tower and pairing (plonk_tpu_torch/ops/tower.py,
ops/bigpairing.py) against the pure-Python oracle tests/bn254_oracle.py,
on the CPU. The JAX pairing is not compiled here (an hour of XLA:CPU
compile, tests/test_plonk_bn254.py); the oracle is independent of both
implementations and its final exponent is the plain (p^12 - 1)/r.
Values are compared exactly.
"""
import random

import numpy as np
import pytest
import torch

import bn254_oracle as O
from plonk_tpu_torch.ops import bigcurve as BC
from plonk_tpu_torch.ops import bigpairing as BP
from plonk_tpu_torch.ops import tower as T

torch.set_num_threads(1)   # see tests/test_torch_bigfield.py

F = BP.pairing_field()
G2 = (O.G2_GEN_X, O.G2_GEN_Y)


def _r2(rnd):
    return (rnd.randrange(O.P), rnd.randrange(O.P))


def _r12(rnd):
    return tuple(tuple(_r2(rnd) for _ in range(3)) for _ in range(2))


@pytest.fixture(scope="module")
def elems():
    rnd = random.Random(5)
    a, b = _r12(rnd), _r12(rnd)
    return a, b, T.f12_encode_host(F, a, "cpu"), T.f12_encode_host(F, b, "cpu")


@pytest.mark.parametrize("op", ["mul", "sq", "inv", "conj", "frob1",
                                "frob2", "frob3"])
def test_fq12_ops_match_oracle(elems, op):
    a, b, A, B = elems
    got, want = dict(
        mul=(lambda: T.f12_mul(F, A, B), lambda: O.f12_mul(a, b)),
        sq=(lambda: T.f12_sq(F, A), lambda: O.f12_sq(a)),
        inv=(lambda: T.f12_inv(F, A), lambda: O.f12_inv(a)),
        conj=(lambda: T.f12_conj(F, A), lambda: O.f12_conj(a)),
        frob1=(lambda: T.f12_frobenius(F, A, 1),
               lambda: O.f12_frobenius(a, 1)),
        frob2=(lambda: T.f12_frobenius(F, A, 2),
               lambda: O.f12_frobenius(a, 2)),
        frob3=(lambda: T.f12_frobenius(F, A, 3),
               lambda: O.f12_frobenius(a, 3)))[op]
    assert T.f12_decode_host(F, got()) == want()


@pytest.mark.parametrize("op", ["mul", "sq", "inv", "mul_xi", "conj"])
def test_fq2_ops_match_oracle(op):
    rnd = random.Random(7)
    xs = [_r2(rnd) for _ in range(4)] + [(0, 0), (1, 0)]
    ys = [_r2(rnd) for _ in range(6)]
    X, Y = F.array(xs, "cpu"), F.array(ys, "cpu")
    got = dict(mul=lambda: T.f2_mul(F, X, Y), sq=lambda: T.f2_sq(F, X),
               inv=lambda: T.f2_inv(F, X), mul_xi=lambda: T.f2_mul_xi(F, X),
               conj=lambda: T.f2_conj(F, X))[op]()
    ref = dict(mul=lambda x, y: O.f2_mul(x, y), sq=lambda x, y: O.f2_sq(x),
               inv=lambda x, y: (O.f2_inv(x) if x != (0, 0) else (0, 0)),
               mul_xi=lambda x, y: O.f2_mul_xi(x),
               conj=lambda x, y: O.f2_conj(x))[op]
    dec = F.decode_host(got)
    assert [(int(d[0]), int(d[1])) for d in dec] == [ref(x, y)
                                                     for x, y in zip(xs, ys)]


def test_fq12_identities(elems):
    _, _, A, _ = elems
    one = T.f12_one(F, (), "cpu")
    assert bool(T.f12_eq(F, T.f12_mul(F, A, T.f12_inv(F, A)), one))
    assert bool(T.f12_eq(F, T.f12_frobenius(F, T.f12_frobenius(
        F, A, 1), 1), T.f12_frobenius(F, A, 2)))


def test_g2_generator_and_mul_match_oracle():
    q = BP.g2_generator(F, (), "cpu")
    x, y, inf = BP.g2_to_affine(F, q)
    assert bool(BP.g2_on_curve(F, x, y)) and not bool(inf)
    k = 0xDEADBEEF
    qk = BP.g2_mul_bits(F, q, BC.scalar_to_bits(k, 32), 32)
    x, y, _ = BP.g2_to_affine(F, qk)
    want = O.g2_mul(G2, k)
    got = tuple(tuple(int(v) for v in F.decode_host(c)) for c in (x, y))
    assert got == want


@pytest.fixture(scope="module")
def pairings():
    """e(a G, H), e(G, b H) and e(ab G, H) from one batched pairing of
    three lanes, and the oracle's e(G, H)."""
    a, b = 6, 35
    g = BC.bn254_generator(F, (3,), "cpu")
    bits = np.stack([BC.scalar_to_bits(k, 8) for k in (a, 1, a * b)])
    p = BC.big_jac_mul(F, g, bits, 8)
    q = BP.g2_generator(F, (), "cpu")
    qb = BP.g2_mul_bits(F, q, BC.scalar_to_bits(b, 8), 8)
    hx, hy, _ = BP.g2_to_affine(F, q)
    bx, by, _ = BP.g2_to_affine(F, qb)
    qx = torch.stack([hx, bx, hx])
    qy = torch.stack([hy, by, hy])
    return BP.pairing(F, p, qx, qy), O.pairing(O.G1_GEN, G2), a, b


def test_pairing_matches_oracle(pairings):
    e, e1, a, b = pairings
    assert T.f12_decode_host(F, e[0]) == O.f12_pow(e1, a)


def test_pairing_bilinear(pairings):
    e, _, a, b = pairings
    # e(aG, H)^b == e(abG, H) == e(G, bH)^a
    assert torch.equal(_pow(e[0], b), e[2])
    assert torch.equal(_pow(e[1], a), e[2])
    assert not bool(T.f12_eq(F, e[1], T.f12_one(F, (), "cpu")))


def _pow(x, k):
    acc = T.f12_one(F, (), "cpu")
    for bit in bin(k)[2:]:
        acc = T.f12_sq(F, acc)
        if bit == "1":
            acc = T.f12_mul(F, acc, x)
    return acc


def test_pairing_of_infinity_is_one():
    p = BC.BigG1J.identity(F, (1,), "cpu")
    q = BP.g2_generator(F, (), "cpu")
    qx, qy, _ = BP.g2_to_affine(F, q)
    e = BP.pairing(F, p, qx[None], qy[None])
    assert bool(T.f12_eq(F, e[0], T.f12_one(F, (), "cpu")))
