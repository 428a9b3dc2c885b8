"""Poseidon permutation and sponge over a single-word scalar field: the
Fiat–Shamir hash that lives on the device.

Port of `plonk_tpu/ops/poseidon.py`. The construction is the JAX
package's own, versioned by `_SEED_FMT`, so both packages derive the same
parameters and the same digests:

- x^alpha S-box with the smallest alpha >= 3 coprime to p - 1 (alpha = 5
  for the scaled field r = 27*2^22 + 1);
- R_F full rounds (default 8) + R_P partial rounds (S-box on lane 0
  only); for the scaled field t = 8 and 8 + 22 rounds, for BN254-Fr
  (the BN254 transcript's t = 3) 8 + 118 rounds;
- round constants from SHA-256 in counter mode over a seed string that
  binds p, t, alpha and the schedule;
- MDS matrix the Cauchy matrix 1/(x_i + y_j), x_i = i, y_j = t + j.

Everything exists three times: `permute`, `absorb_elements`, `squeeze`
and `tree_digest` on single-word Montgomery words in tensors of shape
(..., t); their 16-limb siblings `big_permute`, `big_absorb_elements`,
`big_squeeze` and `big_tree_digest` on `BigMontField` words of shape
(..., t, limbs) (both PyTorch ops; the JAX package has no Pallas kernel
for them); and the Python-int oracle (`PoseidonHost`, `HostSponge`,
`host_tree_digest`), arbitrary-precision, that a verifier replays on the
host. Their words are equal (tests/test_torch_poseidon.py).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math

import numpy as np
import torch

_SEED_FMT = "tpu-plonk-poseidon-v1/p={p}/t={t}/alpha={alpha}/rf={rf}/rp={rp}"


def _sbox_alpha(p: int) -> int:
    a = 3
    while math.gcd(a, p - 1) != 1:
        a += 2
    return a


@dataclasses.dataclass(frozen=True)
class PoseidonParams:
    """Host-side (Python int) Poseidon parameter set: `arc[r][i]` is the
    round constant added to lane i before round r's S-box, `mds[i][j]` the
    state matrix, all in standard form mod p."""
    p: int
    t: int
    alpha: int
    full_rounds: int
    partial_rounds: int
    arc: tuple          # (R, t) of int
    mds: tuple          # (t, t) of int

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    def is_full_round(self, r: int) -> bool:
        half = self.full_rounds // 2
        return r < half or r >= half + self.partial_rounds


@functools.lru_cache(maxsize=None)
def make_params(p: int, t: int = 8, full_rounds: int = 8,
                partial_rounds: int | None = None) -> PoseidonParams:
    """Deterministic parameters for field modulus p and width t; the
    partial rounds default to max(22, ceil(log2(p) / log2(alpha)) + 8)."""
    alpha = _sbox_alpha(p)
    if partial_rounds is None:
        partial_rounds = max(22, math.ceil(p.bit_length()
                                           / math.log2(alpha)) + 8)
    seed = _SEED_FMT.format(p=p, t=t, alpha=alpha, rf=full_rounds,
                            rp=partial_rounds)
    R = full_rounds + partial_rounds

    def draw(tag: str, i: int) -> int:
        h = hashlib.sha256(f"{seed}/{tag}/{i}".encode()).digest()
        h += hashlib.sha256(f"{seed}/{tag}/{i}/hi".encode()).digest()
        return int.from_bytes(h, "little") % p

    arc = tuple(tuple(draw("arc", r * t + i) for i in range(t))
                for r in range(R))
    mds = tuple(tuple(pow((i + t + j) % p, p - 2, p) for j in range(t))
                for i in range(t))
    return PoseidonParams(p=p, t=t, alpha=alpha, full_rounds=full_rounds,
                          partial_rounds=partial_rounds, arc=arc, mds=mds)


# ---------------- host oracle (Python ints) ----------------


class PoseidonHost:
    """Python-int Poseidon, the verifier's oracle: state, inputs and
    outputs are canonical ints mod p."""

    def __init__(self, params: PoseidonParams):
        self.pp = params

    def permute(self, state):
        pp = self.pp
        p, t, alpha = pp.p, pp.t, pp.alpha
        s = list(state)
        if len(s) != t:
            raise ValueError(f"state of {len(s)} elements, want {t}")
        for r in range(pp.rounds):
            s = [(x + c) % p for x, c in zip(s, pp.arc[r])]
            if pp.is_full_round(r):
                s = [pow(x, alpha, p) for x in s]
            else:
                s[0] = pow(s[0], alpha, p)
            s = [sum(pp.mds[i][j] * s[j] for j in range(t)) % p
                 for i in range(t)]
        return s


# ---------------- tensor permutation (Montgomery words) ----------------


@functools.lru_cache(maxsize=None)
def _tables(F, params: PoseidonParams, device) -> tuple:
    """(arc (R, t), mds (t, t)) as Montgomery words on `device`."""
    if params.p != F.p:
        raise ValueError("the Poseidon parameters are for another field")
    return (F.array(np.asarray(params.arc, dtype=np.int64), device),
            F.array(np.asarray(params.mds, dtype=np.int64), device))


def _pow_alpha(F, x: torch.Tensor, alpha: int) -> torch.Tensor:
    """x^alpha by square-and-multiply on the small static exponent."""
    acc = None
    base = x
    e = alpha
    while e:
        if e & 1:
            acc = base if acc is None else F.mul(acc, base)
        e >>= 1
        if e:
            base = F.square(base)
    return acc


def permute(F, params: PoseidonParams, state: torch.Tensor) -> torch.Tensor:
    """The permutation on a (..., t) Montgomery-form state: R rounds of
    round constants, S-box (every lane in a full round, lane 0 in a
    partial one) and the MDS product."""
    arc, mds = _tables(F, params, state.device)
    s = state
    for r in range(params.rounds):
        s = F.add(s, arc[r])
        if params.is_full_round(r):
            s = _pow_alpha(F, s, params.alpha)
        else:
            s = torch.cat([_pow_alpha(F, s[..., :1], params.alpha),
                           s[..., 1:]], dim=-1)
        # out_i = sum_j mds[i, j] * s_j
        prod = F.mul(mds, s[..., None, :])
        acc = prod[..., 0]
        for j in range(1, params.t):
            acc = F.add(acc, prod[..., j])
        s = acc
    return s


# ---------------- sponge ----------------
#
# Each absorb call takes a statically known list of elements, 10*-padded
# to whole rate-blocks. A squeeze permutes and emits state[0]; rejection
# resampling permutes again, identically on both sides.


def rate_of(params: PoseidonParams, capacity: int = 4) -> int:
    r = params.t - capacity
    if r < 1:
        raise ValueError(f"capacity {capacity} leaves no rate at t = "
                         f"{params.t}")
    return r


def pad_elements(elems: list, rate: int) -> list:
    """10* padding to a whole number of rate-blocks."""
    out = list(elems) + [1]
    while len(out) % rate:
        out.append(0)
    return out


def absorb(F, params: PoseidonParams, state: torch.Tensor,
           block: torch.Tensor, capacity: int = 4) -> torch.Tensor:
    """One duplex absorb of a (..., rate) Montgomery-form block."""
    rate = rate_of(params, capacity)
    if block.shape[-1] != rate:
        raise ValueError(f"block of {block.shape[-1]} elements, rate {rate}")
    mixed = F.add(state[..., :rate], block)
    return permute(F, params, torch.cat([mixed, state[..., rate:]], dim=-1))


def absorb_elements(F, params: PoseidonParams, state: torch.Tensor,
                    elems: list, capacity: int = 4) -> torch.Tensor:
    """Absorb a list of Montgomery-form elements (tensors of the state's
    batch shape, or Python ints in standard form), 10*-padded."""
    rate = rate_of(params, capacity)
    batch = state.shape[:-1]
    padded = [torch.full(batch, F.const(e), dtype=state.dtype,
                         device=state.device) if isinstance(e, int)
              else e.expand(batch) for e in pad_elements(elems, rate)]
    for i in range(0, len(padded), rate):
        state = absorb(F, params, state,
                       torch.stack(padded[i:i + rate], dim=-1), capacity)
    return state


def squeeze(F, params: PoseidonParams, state: torch.Tensor,
            reject_zero: bool = True, pow_n_not_one: int | None = None):
    """Squeeze one element per lane with deterministic rejection
    resampling: permute again while the candidate is inadmissible (0, or
    optionally v^n == 1). Lanes that are done keep their state while the
    others permute, as JAX's while loop does under vmap. Returns (value in
    standard form, state)."""

    def bad(v):
        b = torch.zeros_like(v, dtype=torch.bool)
        if reject_zero:
            b = b | (v == 0)
        if pow_n_not_one is not None:
            b = b | (F.pow_static(v, pow_n_not_one) == F.const(1))
        return b

    state = permute(F, params, state)
    redo = bad(state[..., 0])
    while bool(redo.any()):
        state = torch.where(redo[..., None], permute(F, params, state), state)
        redo = bad(state[..., 0])
    return F.decode(state[..., 0]), state


def tree_digest(F, params: PoseidonParams, leaves) -> torch.Tensor:
    """Binary Poseidon tree hash of (..., m) standard-form vectors (m a
    power of two): log2(m) batched permutations, parent =
    permute([l, r, 0..])[0]. Returns the (...) Montgomery-form digests."""
    x = F.encode(leaves)
    t = params.t
    while x.shape[-1] > 1:
        half = x.shape[:-1] + (x.shape[-1] // 2,)
        state = torch.cat([x[..., 0::2, None], x[..., 1::2, None],
                           F.zeros(half + (t - 2,), x.device)], dim=-1)
        x = permute(F, params, state)[..., 0]
    return x[..., 0]


def host_tree_digest(params: PoseidonParams, leaves) -> int:
    """The Python-int tree_digest. A pair met before at the same call is
    not permuted again, so a tree of repeated leaves (the all-zero public
    inputs) costs one permutation a level."""
    perm = PoseidonHost(params)
    xs = [int(v) % params.p for v in leaves]
    while len(xs) > 1:
        parents = {}
        for pair in zip(xs[0::2], xs[1::2]):
            if pair not in parents:
                parents[pair] = perm.permute(
                    list(pair) + [0] * (params.t - 2))[0]
        xs = [parents[pair] for pair in zip(xs[0::2], xs[1::2])]
    return xs[0]


# ---------------- 16-limb (BN254-class) permutation and sponge ----------
#
# The same permutation and sponge over a BigMontField: a state is
# (..., t, limbs) Montgomery words, an element (..., limbs). The BN254
# transcript runs them at t = 3, capacity 1 (models/fs_poseidon.py).


@functools.lru_cache(maxsize=None)
def _big_tables(F, params: PoseidonParams, device: str) -> tuple:
    """(arc (R, t, limbs), mds (t, t, limbs)) as Montgomery words on
    `device` (JAX's `_big_host_tables`)."""
    if params.p != F.p:
        raise ValueError("the Poseidon parameters are for another field")
    return (F.array(np.asarray(params.arc, dtype=object), device),
            F.array(np.asarray(params.mds, dtype=object), device))


def big_permute(F, params: PoseidonParams, state: torch.Tensor
                ) -> torch.Tensor:
    """The permutation on a (..., t, limbs) Montgomery-form state: R rounds
    of round constants, S-box (every lane in a full round, lane 0 in a
    partial one) and the t x t MDS product."""
    arc, mds = _big_tables(F, params, str(state.device))
    s = state
    for r in range(params.rounds):
        s = F.add(s, arc[r])
        if params.is_full_round(r):
            s = _pow_alpha(F, s, params.alpha)
        else:
            s = torch.cat([_pow_alpha(F, s[..., :1, :], params.alpha),
                           s[..., 1:, :]], dim=-2)
        # out_i = sum_j mds[i, j] * s_j over the state axis
        prod = F.mont_mul(mds, s[..., None, :, :])
        acc = prod[..., 0, :]
        for j in range(1, params.t):
            acc = F.add(acc, prod[..., j, :])
        s = acc
    return s


def big_absorb_elements(F, params: PoseidonParams, state: torch.Tensor,
                        elems: list, capacity: int = 1) -> torch.Tensor:
    """Duplex-absorb a list of Montgomery-form elements (tensors of shape
    (..., limbs) that broadcast to the state's batch, or Python ints in
    standard form), 10*-padded, one permutation a rate-block."""
    rate = rate_of(params, capacity)
    batch = state.shape[:-2]
    padded = [F.full(e, batch, state.device) if isinstance(e, int)
              else e.expand(batch + (F.limbs,))
              for e in pad_elements(elems, rate)]
    for i in range(0, len(padded), rate):
        block = torch.stack(padded[i:i + rate], dim=-2)   # (..., rate, L)
        mixed = F.add(state[..., :rate, :], block)
        state = big_permute(F, params,
                            torch.cat([mixed, state[..., rate:, :]], dim=-2))
    return state


def big_squeeze(F, params: PoseidonParams, state: torch.Tensor,
                reject_zero: bool = True, pow_n_not_one: int | None = None):
    """Squeeze one element per lane with deterministic rejection
    resampling (0, or optionally v^n == 1, permute again). Lanes that are
    done keep their state while the others permute, as JAX's while loop
    does under vmap. Returns (standard-form words (..., limbs), state)."""

    def bad(v):
        b = torch.zeros(v.shape[:-1], dtype=torch.bool, device=v.device)
        if reject_zero:
            b = b | F.is_zero(v)
        if pow_n_not_one is not None:
            b = b | F.eq(F.pow_static(v, pow_n_not_one), F.const(1))
        return b

    state = big_permute(F, params, state)
    redo = bad(state[..., 0, :])
    while bool(redo.any()):
        state = torch.where(redo[..., None, None],
                            big_permute(F, params, state), state)
        redo = bad(state[..., 0, :])
    return F.decode(state[..., 0, :]), state


def big_tree_digest(F, params: PoseidonParams, leaves) -> torch.Tensor:
    """Binary Poseidon tree over (..., m, limbs) standard-form leaves (m a
    power of two): log2(m) batched permutations, parent =
    permute([l, r, 0..])[0]. Returns the (..., limbs) Montgomery-form
    digests; host mirror: host_tree_digest."""
    x = F.encode(leaves)
    t = params.t
    while x.shape[-2] > 1:
        half = x.shape[:-2] + (x.shape[-2] // 2,)
        state = torch.cat([x[..., 0::2, None, :], x[..., 1::2, None, :],
                           F.zeros(half + (t - 2,), x.device)], dim=-2)
        x = big_permute(F, params, state)[..., 0, :]
    return x[..., 0, :]


class HostSponge:
    """Python-int mirror of (absorb_elements, squeeze): the verifier's
    transcript replay."""

    def __init__(self, params: PoseidonParams, capacity: int = 4):
        self.pp = params
        self.capacity = capacity
        self.rate = rate_of(params, capacity)
        self.perm = PoseidonHost(params)
        self.state = [0] * params.t

    def absorb_elements(self, elems):
        padded = pad_elements([int(e) % self.pp.p for e in elems],
                              self.rate)
        for i in range(0, len(padded), self.rate):
            blk = padded[i:i + self.rate]
            for j, v in enumerate(blk):
                self.state[j] = (self.state[j] + v) % self.pp.p
            self.state = self.perm.permute(self.state)

    def squeeze(self, reject_zero: bool = True,
                pow_n_not_one: int | None = None) -> int:
        p = self.pp.p

        def bad(v):
            if reject_zero and v == 0:
                return True
            return (pow_n_not_one is not None
                    and pow(v, pow_n_not_one, p) == 1)

        self.state = self.perm.permute(self.state)
        while bad(self.state[0]):
            self.state = self.perm.permute(self.state)
        return self.state[0]
