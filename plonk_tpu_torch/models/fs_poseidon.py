"""Non-interactive scaled prover with a Poseidon transcript on the device.

Port of `plonk_tpu/models/fs_poseidon.py`: the scaled and the BN254
provers. With an algebraic sponge (ops/poseidon.py) the
challenges are field arithmetic on the prover's device: the sponge state
never leaves it, and only the retry test and the squeezes' rejection tests
read a flag back. The verifier replays the transcript with the Python-int
oracle on the host.

Transcript layout (poseidon-v1; each bullet is one `absorb_elements` call,
10*-padded on its own):

    preamble  label (16-bit chunks), r/n/k1/k2/omega, the 8 vk points
    per-try   [tree_digest(PI), nonce]
    round 1   [a]_1 [b]_1 [c]_1 (point chunks)      -> beta, gamma
    round 2   [z]_1                                 -> alpha
    round 3   [t_lo] [t_mid] [t_hi]                 -> z  (z^n != 1)
    round 4   the 7 evaluations                     -> v

A point absorbs as the 16-bit halves of its x and y words and its
infinity flag (each below r, so the encoding is injective); the public
inputs enter as a Poseidon tree digest. An inadmissible beta/gamma
(vanishing permutation denominator, src/plonk.h:506-510) makes the prover
retry with the next public nonce, up to nonce MAX_NONCE: 33 attempts, as
the JAX package's while loop makes.

The BN254 prover runs the same layout over the 16-limb sponge at t = 3,
capacity 1 (rate 2): a G1 coordinate lives in Fq, not the sponge's Fr,
so each absorbs as its two 128-bit halves (each below r), then the
infinity flag; evaluations are Fr elements and absorb as they are.

Both provers' `prove_many` run B proofs as one batched pass, as the JAX
package's vmapped run does: every stage, commitment and sponge call takes
the whole batch, and the nonce retry is one host loop over nonces in
which the lanes whose denominator was admissible keep their attempt while
the rest retry (`_retry_nonces`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import torch.nn.functional as TF

from ..ops import poseidon as PO
from ..utils.params import BN254_FR
from .fiat_shamir import _BN254Stages, _bn254_words, _host, _points
from .plonk import SCALAR_FIELDS, Proof
from . import plonk_bn254 as PB
from . import plonk_scaled as PS
from .synthetic import from_words

LABEL = b"tpu-plonk-fs-poseidon-v1"
MAX_NONCE = 32


def _label_elements(label: bytes) -> list:
    """bytes -> 16-bit-chunk field elements (length-prefixed)."""
    out = [len(label)]
    padded = label + b"\x00" * (len(label) % 2)
    for i in range(0, len(padded), 2):
        out.append(int.from_bytes(padded[i:i + 2], "little"))
    return out


def _int_chunks(v: int, n_chunks: int) -> list:
    return [(int(v) >> (16 * k)) & 0xFFFF for k in range(n_chunks)]


def _host_point_elements(pt) -> list:
    """G1 point -> [x_lo, x_hi, y_lo, y_hi, inf] ints of its words."""
    return (_int_chunks(int(_host(pt.x)), 2)
            + _int_chunks(int(_host(pt.y)), 2)
            + [int(bool(_host(pt.inf)))])


def _preamble_elements(ctx, vk_points) -> list:
    pp = ctx.params
    r = pp.field.p
    elems = _label_elements(LABEL)
    elems += _int_chunks(r, 4) + [ctx.n, pp.k1, pp.k2, pp.omega % r]
    for pt in vk_points:
        elems += _host_point_elements(pt)
    return elems


def _device_point_elements(F, pts) -> list:
    """Points (0-d tensors) -> Montgomery 0-d absorb list, chunked as
    _host_point_elements."""
    out = []
    for pt in pts:
        for c in (pt.x & 0xFFFF, pt.x >> 16, pt.y & 0xFFFF, pt.y >> 16,
                  pt.inf.to(torch.int64)):
            out.append(F.encode(c))
    return out


def _lane_where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor
                ) -> torch.Tensor:
    """`new` on the lanes of `mask` (a bool tensor of the batch shape),
    `old` on the others."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim()
                                                         - mask.dim())),
                       new, old)


def _retry_nonces(attempt):
    """The nonce retry of every lane at once. attempt(nonce) -> (state,
    beta_std, gamma_std, z_x, den_ok) for all lanes; the lanes whose
    denominator was admissible keep their attempt while the others take
    the next nonce's, as JAX's while loop does under vmap. One host read
    a nonce. Returns ((state, beta_std, gamma_std, z_x), the lanes' nonces
    as a numpy array of the batch shape); RuntimeError when a lane finds
    no admissible beta/gamma up to MAX_NONCE."""
    kept = None
    for nonce in range(MAX_NONCE + 1):
        new = attempt(nonce)
        if kept is None:
            kept = new
            nonces = np.zeros(tuple(new[-1].shape), dtype=np.int64)
        else:
            kept = tuple(_lane_where(retry, a, b) for a, b in zip(new, kept))
            nonces = np.where(retry_h, nonce, nonces)
        retry = ~kept[-1]
        retry_h = retry.cpu().numpy()
        if not retry_h.any():
            return kept[:-1], nonces
    raise RuntimeError(
        "no admissible beta/gamma in %d retries" % MAX_NONCE)


def _one_lane(device, *xs) -> list:
    """One proof's inputs as a batch of one (None stays None)."""
    return [None if x is None else PS._as_words(x, device)[None]
            for x in xs]


def _check_batch(a_w, rank: int, shape: str) -> None:
    """prove_many's witness columns must carry a leading batch axis;
    checked before any stage runs."""
    if np.ndim(a_w) != rank:
        raise ValueError("prove_many takes a leading batch axis: %s "
                         "witness columns" % shape)


def _split_lanes(batch) -> list:
    """(proof, nonces, challenges, diags) of a batch -> the list of
    (PoseidonFsProof, diags) of its lanes."""
    proof, nonces, ch, diags = batch
    return [(PoseidonFsProof(proof=_lane(proof, i), nonce=int(nonces[i]),
                             challenge=ch[i]), _lane(diags, i))
            for i in range(len(nonces))]


def _lane(t, i: int):
    """Lane i of a batched proof or diagnostics (NamedTuples of tensors
    with a leading batch axis)."""
    if isinstance(t, tuple):
        return type(t)(*(_lane(f, i) for f in t))
    return t[i]


class PoseidonFsProof(NamedTuple):
    proof: object           # models.plonk.Proof (scaled points + evals)
    nonce: int
    challenge: np.ndarray   # [alpha beta gamma z v] standard form


class PoseidonFsProver:
    """Non-interactive prover for a fixed scaled circuit with the sponge on
    the context's device. The verifying key, window table, circuit tables,
    post-preamble sponge state and the digest of all-zero public inputs
    are made once.

        fs = PoseidonFsProver(ctx, selectors, copies)
        out, diags = fs.prove(a_w, b_w, c_w, rand9)
        assert verify_scaled_fs_poseidon(ctx, fs.vk, out)
    """

    def __init__(self, ctx, selectors, copies, prims=None,
                 capacity: int = 4):
        self.ctx = ctx
        self.capacity = capacity
        Fr = ctx.Fr
        dev = ctx.device
        self.pos = PO.make_params(ctx.params.field.p)
        self.vk = PS.make_vk_scaled(ctx, selectors, copies)
        self._vk_points = list(self.vk)
        # the preamble is proof-independent: absorbed once on the host, its
        # state encoded once
        hs = PO.HostSponge(self.pos, capacity)
        hs.absorb_elements(_preamble_elements(ctx, self._vk_points))
        self._state0 = Fr.array(np.asarray(hs.state, dtype=np.int64), dev)
        self._zero_pi_digest = PO.tree_digest(
            Fr, self.pos, Fr.zeros((ctx.n,), dev))
        base = prims if prims is not None else PS._auto_prims(ctx)
        self._pre = PS.precompute_circuit(ctx, selectors, copies, base)
        self._prims = base._replace(
            commit_many=PS.table_commit(ctx, PS.fixed_base_table(ctx)))

    def _absorb(self, s, elems):
        return PO.absorb_elements(self.ctx.Fr, self.pos, s, elems,
                                  self.capacity)

    def _squeeze(self, s, pow_n_not_one=None):
        return PO.squeeze(self.ctx.Fr, self.pos, s,
                          pow_n_not_one=pow_n_not_one)

    def _prove(self, a_w, b_w, c_w, rand9, public_inputs):
        """The B proofs of (B, n) inputs in one pass: each stage,
        commitment and sponge call runs once for the whole batch. Returns
        (Proof, nonces (B,), challenges (B, 5), ScaledDiagnostics), the
        nonces and challenges as numpy arrays."""
        ctx, prims = self.ctx, self._prims
        Fr = ctx.Fr
        commit = lambda polys: _points(prims.commit_many(ctx, polys))
        st = PS._stage_prep(ctx, a_w, b_w, c_w, rand9, prims, self._pre,
                            public_inputs)
        pt1 = commit([st["a_x"], st["b_x"], st["c_x"]])
        c1_elems = _device_point_elements(Fr, pt1)
        pid = (self._zero_pi_digest if public_inputs is None else
               PO.tree_digest(Fr, self.pos,
                              PS._as_words(public_inputs, ctx.device)))
        state0 = self._state0.expand(st["a_v"].shape[:-1]
                                     + self._state0.shape)

        def attempt(nonce):
            s = self._absorb(state0, [pid, nonce])
            s = self._absorb(s, c1_elems)
            beta_std, s = self._squeeze(s)
            gamma_std, s = self._squeeze(s)
            z_x, den_ok = PS._stage_grand_product(
                ctx, st, Fr.encode(beta_std), Fr.encode(gamma_std), prims)
            return s, beta_std, gamma_std, z_x, den_ok

        (s, beta_std, gamma_std, z_x), nonces = _retry_nonces(attempt)
        beta, gamma = Fr.encode(beta_std), Fr.encode(gamma_std)

        (z_pt,) = commit([z_x])
        s = self._absorb(s, _device_point_elements(Fr, [z_pt]))
        alpha_std, s = self._squeeze(s)
        alpha = Fr.encode(alpha_std)
        q3 = PS._stage_quotient(ctx, st, z_x, alpha, beta, gamma, prims)
        pt3 = commit([q3["t_lo_x"], q3["t_mid_x"], q3["t_hi_x"]])
        s = self._absorb(s, _device_point_elements(Fr, pt3))
        z_std, s = self._squeeze(s, pow_n_not_one=ctx.n)
        zc = Fr.encode(z_std)

        # the evaluations do not depend on v: evaluate with v = 1, absorb,
        # squeeze the real v, then open
        one = torch.full((), Fr.const(1), dtype=torch.int64,
                         device=ctx.device)
        q5 = PS._stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, zc,
                                one)
        s = self._absorb(s, [q5[k] for k in SCALAR_FIELDS])
        v_std, s = self._squeeze(s)
        q5 = PS._stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, zc,
                                Fr.encode(v_std))
        pt4 = commit([q5["w_z_x_quo"], q5["w_z_omega_x"]])
        ch = torch.stack([alpha_std, beta_std, gamma_std, z_std, v_std],
                         dim=-1)

        proof = Proof(
            a_s=pt1[0], b_s=pt1[1], c_s=pt1[2], z_s=z_pt,
            t_lo_s=pt3[0], t_mid_s=pt3[1], t_hi_s=pt3[2],
            w_z_s=pt4[0], w_z_omega_s=pt4[1],
            **{k: Fr.decode(q5[k]) for k in SCALAR_FIELDS})
        diags = PS.ScaledDiagnostics(
            satisfied=st["satisfied"], t_tail_zero=q3["t_tail_zero"],
            w_z_rem_zero=q5["rem1"] == 0, w_zw_rem_zero=q5["rem2"] == 0)
        return proof, nonces, _host(ch).astype(np.uint32), diags

    def prove(self, a_w, b_w, c_w, rand9, public_inputs=None):
        """One proof, as prove_many of one lane. Returns (PoseidonFsProof,
        ScaledDiagnostics); RuntimeError when no nonce up to MAX_NONCE
        gives an admissible beta/gamma."""
        return self.prove_many(*_one_lane(self.ctx.device, a_w, b_w, c_w,
                                          rand9, public_inputs))[0]

    def prove_many(self, a_w, b_w, c_w, rand9, public_inputs=None):
        """B proofs in one batched pass: (B, n) witness columns, (B, 9)
        blinding and (B, n) public inputs or None; returns a list of
        (PoseidonFsProof, diags), lane i equal to prove() of lane i (its
        own nonce included). RuntimeError when any lane exhausts
        MAX_NONCE, as the JAX package's prove_many raises."""
        _check_batch(a_w, 2, "(B, n)")
        return _split_lanes(self._prove(a_w, b_w, c_w, rand9,
                                        public_inputs))


def derive_challenges_host(ctx, vk_points, proof, nonce: int,
                           public_inputs=None, capacity: int = 4,
                           pi_digest: int | None = None) -> np.ndarray:
    """Verifier-side transcript replay with the Python-int Poseidon.
    The public-input digest is `pi_digest` when given (standard form),
    else host_tree_digest of the public inputs (zeros when None). Returns
    [alpha beta gamma z v] in standard form."""
    pos = PO.make_params(ctx.params.field.p)
    n = ctx.n
    hs = PO.HostSponge(pos, capacity)
    hs.absorb_elements(_preamble_elements(ctx, vk_points))
    if pi_digest is None:
        pi = ([0] * n if public_inputs is None
              else [int(v) for v in _host(public_inputs)])
        pi_digest = PO.host_tree_digest(pos, pi)
    hs.absorb_elements([pi_digest, int(nonce)])
    hs.absorb_elements(
        _host_point_elements(proof.a_s) + _host_point_elements(proof.b_s)
        + _host_point_elements(proof.c_s))
    beta = hs.squeeze()
    gamma = hs.squeeze()
    hs.absorb_elements(_host_point_elements(proof.z_s))
    alpha = hs.squeeze()
    hs.absorb_elements(
        _host_point_elements(proof.t_lo_s)
        + _host_point_elements(proof.t_mid_s)
        + _host_point_elements(proof.t_hi_s))
    z = hs.squeeze(pow_n_not_one=n)
    hs.absorb_elements([int(_host(getattr(proof, k))) for k in SCALAR_FIELDS])
    v = hs.squeeze()
    return np.array([alpha, beta, gamma, z, v], dtype=np.uint32)


def verify_scaled_fs_poseidon(ctx, vk, fs_proof: PoseidonFsProof,
                              public_inputs=None) -> bool:
    """Replay the Poseidon transcript on the host and run the two-pairing
    check; a tampered commitment or evaluation shifts the derived
    challenges and breaks the pairing identity. The public-input digest
    comes from `tree_digest` on the context's device (the words of
    host_tree_digest; on the host it would be about 20 s at 2^16 inputs);
    the rest of the replay runs on the host."""
    Fr = ctx.Fr
    pos = PO.make_params(ctx.params.field.p)
    pi = (Fr.zeros((ctx.n,), ctx.device) if public_inputs is None
          else PS._as_words(public_inputs, ctx.device))
    pid = int(Fr.decode(PO.tree_digest(Fr, pos, pi)))
    ch = derive_challenges_host(ctx, list(vk), fs_proof.proof,
                                fs_proof.nonce, pi_digest=pid)
    return PS.verify_scaled(ctx, vk, fs_proof.proof, ch,
                            public_inputs=public_inputs)


# ---------------- BN254 (production curve, 16-limb sponge) -------------

BN254_LABEL = b"tpu-plonk-bn254-fs-poseidon-v1"
BN254_CAPACITY = 1
_M128 = (1 << 128) - 1


def _bn254_host_point_elements(pt) -> list:
    """Standard-form BigG1Affine -> [x_lo, x_hi, y_lo, y_hi, inf] ints
    (128-bit halves)."""
    x, y = from_words(_host(pt.x)), from_words(_host(pt.y))
    return [x & _M128, x >> 128, y & _M128, y >> 128,
            int(bool(_host(pt.inf)))]


def _bn254_preamble_elements(ctx, vk_points) -> list:
    r = BN254_FR.p
    elems = _label_elements(BN254_LABEL)
    elems += [r & _M128, r >> 128, ctx.n, ctx.k1, ctx.k2, ctx.omega % r]
    for pt in vk_points:
        elems += _bn254_host_point_elements(pt)
    return elems


def _bn254_device_point_elements(F, pts) -> list:
    """Standard-form points (words on the device) -> Montgomery (..., 16)
    absorb list, chunked as _bn254_host_point_elements: each coordinate's
    low and high 8 words, then the flag, encoded in one product."""
    rows = []
    for pt in pts:
        for w in (pt.x, pt.y):
            rows += [TF.pad(w[..., :8], (0, 8)), TF.pad(w[..., 8:], (0, 8))]
        rows.append(TF.pad(pt.inf.to(torch.int64)[..., None], (0, 15)))
    return list(F.encode(torch.stack(rows)).unbind(0))


class BN254PoseidonFsProver(_BN254Stages):
    """Non-interactive prover for a fixed BN254 circuit with the 16-limb
    sponge on the context's device. The verifying key, the window table
    (on the table route), circuit tables, post-preamble sponge state and
    the digest of all-zero public inputs are made once. Each proof runs
    the four stages of plonk_bn254 (K3 in the quotient, a commitment call
    a round: B = 3, 1, 3, 2, one K4 launch each on the table route);
    only the retry test and the squeezes' rejection tests read a flag
    back.

        fs = BN254PoseidonFsProver(ctx, selectors, copies)
        out, diags = fs.prove(a_w, b_w, c_w, rand9)
        assert verify_bn254_fs_poseidon(ctx, fs.vk, out)
    """

    def __init__(self, ctx, selectors, copies, prims=None):
        super().__init__(ctx, selectors, copies, prims)
        Fr = ctx.Fr
        self.pos = PO.make_params(BN254_FR.p, t=3)
        # the preamble is proof-independent: absorbed once on the host, its
        # state encoded once
        hs = PO.HostSponge(self.pos, BN254_CAPACITY)
        hs.absorb_elements(_bn254_preamble_elements(ctx, self._vk_points))
        self._state0 = Fr.array(np.asarray(hs.state, dtype=object),
                                ctx.device)
        # the zero tree repeats one pair a level: log2(n) host permutations
        self._zero_pi_digest = Fr.array(
            [PO.host_tree_digest(self.pos, [0] * ctx.n)], ctx.device)[0]

    def _absorb(self, s, elems):
        return PO.big_absorb_elements(self.ctx.Fr, self.pos, s, elems,
                                      BN254_CAPACITY)

    def _squeeze(self, s, pow_n_not_one=None):
        return PO.big_squeeze(self.ctx.Fr, self.pos, s,
                              pow_n_not_one=pow_n_not_one)

    def _prove(self, a_w, b_w, c_w, rand9, public_inputs):
        """The B proofs of (B, n, 16) inputs in one pass. Returns
        (BN254Proof, nonces (B,), challenges (B, 5, 16), BN254Diagnostics),
        the nonces and challenge words as numpy arrays."""
        ctx, prims = self.ctx, self._prims
        Fr = ctx.Fr
        st = PB._stage_prep(ctx, a_w, b_w, c_w, rand9, prims, self._pre,
                            public_inputs)
        pt1 = self._commit([st["a_x"], st["b_x"], st["c_x"]])
        c1_elems = _bn254_device_point_elements(Fr, pt1)
        pid = (self._zero_pi_digest if public_inputs is None else
               PO.big_tree_digest(Fr, self.pos,
                                  PB._as_words(public_inputs, ctx.device)))
        state0 = self._state0.expand(st["a_v"].shape[:-2]
                                     + self._state0.shape)

        def attempt(nonce):
            s = self._absorb(state0, [pid, nonce])
            s = self._absorb(s, c1_elems)
            beta_std, s = self._squeeze(s)
            gamma_std, s = self._squeeze(s)
            z_x, den_ok = PB._stage_grand_product(
                ctx, st, Fr.encode(beta_std), Fr.encode(gamma_std), prims)
            return s, beta_std, gamma_std, z_x, den_ok

        (s, beta_std, gamma_std, z_x), nonces = _retry_nonces(attempt)
        beta, gamma = Fr.encode(beta_std), Fr.encode(gamma_std)

        (z_pt,) = self._commit([z_x])
        s = self._absorb(s, _bn254_device_point_elements(Fr, [z_pt]))
        alpha_std, s = self._squeeze(s)
        alpha = Fr.encode(alpha_std)
        q3 = PB._stage_quotient(ctx, st, z_x, alpha, beta, gamma, prims)
        pt3 = self._commit([q3["t_lo_x"], q3["t_mid_x"], q3["t_hi_x"]])
        s = self._absorb(s, _bn254_device_point_elements(Fr, pt3))
        z_std, s = self._squeeze(s, pow_n_not_one=ctx.n)
        zc = Fr.encode(z_std)

        # the evaluations do not depend on v: evaluate with v = 1, absorb,
        # squeeze the real v, then open
        one = Fr.full(1, (), ctx.device)
        q5 = PB._stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, zc,
                                one)
        s = self._absorb(s, [q5[k] for k in SCALAR_FIELDS])
        v_std, s = self._squeeze(s)
        q5 = PB._stage_openings(ctx, st, q3, z_x, alpha, beta, gamma, zc,
                                Fr.encode(v_std))
        pt4 = self._commit([q5["w_z_x_quo"], q5["w_z_omega_x"]])
        ch = torch.stack([alpha_std, beta_std, gamma_std, z_std, v_std],
                         dim=-2)

        proof = self._proof(pt1 + [z_pt] + pt3 + pt4, q5)
        diags = PB.BN254Diagnostics(
            satisfied=st["satisfied"], t_tail_zero=q3["t_tail_zero"],
            w_z_rem_zero=q5["rem1"], w_zw_rem_zero=q5["rem2"])
        return proof, nonces, _host(ch).astype(np.uint32), diags

    def prove(self, a_w, b_w, c_w, rand9, public_inputs=None):
        """One proof, as prove_many of one lane. Returns (PoseidonFsProof,
        BN254Diagnostics); RuntimeError when no nonce up to MAX_NONCE
        gives an admissible beta/gamma."""
        return self.prove_many(*_one_lane(self.ctx.device, a_w, b_w, c_w,
                                          rand9, public_inputs))[0]

    def prove_many(self, a_w, b_w, c_w, rand9, public_inputs=None):
        """B proofs in one batched pass: (B, n, 16) witness columns,
        (B, 9, 16) blinding and (B, n, 16) public inputs or None; returns a
        list of (PoseidonFsProof, diags), lane i equal to prove() of lane
        i (its own nonce included). RuntimeError when any lane exhausts
        MAX_NONCE."""
        _check_batch(a_w, 3, "(B, n, 16)")
        return _split_lanes(self._prove(a_w, b_w, c_w, rand9,
                                        public_inputs))


def derive_bn254_challenges_host(ctx, vk_points, proof, nonce: int,
                                 public_inputs=None) -> np.ndarray:
    """Verifier-side BN254 transcript replay with the Python-int Poseidon
    (the public-input digest too). Returns the (5, 16) standard-form
    challenge words [alpha beta gamma z v]."""
    pos = PO.make_params(BN254_FR.p, t=3)
    n = ctx.n
    hs = PO.HostSponge(pos, BN254_CAPACITY)
    hs.absorb_elements(_bn254_preamble_elements(ctx, vk_points))
    pi = ([0] * n if public_inputs is None
          else [from_words(w) for w in _host(public_inputs)])
    hs.absorb_elements([PO.host_tree_digest(pos, pi), int(nonce)])
    hs.absorb_elements(
        _bn254_host_point_elements(proof.a_s)
        + _bn254_host_point_elements(proof.b_s)
        + _bn254_host_point_elements(proof.c_s))
    beta = hs.squeeze()
    gamma = hs.squeeze()
    hs.absorb_elements(_bn254_host_point_elements(proof.z_s))
    alpha = hs.squeeze()
    hs.absorb_elements(
        _bn254_host_point_elements(proof.t_lo_s)
        + _bn254_host_point_elements(proof.t_mid_s)
        + _bn254_host_point_elements(proof.t_hi_s))
    z = hs.squeeze(pow_n_not_one=n)
    hs.absorb_elements([from_words(_host(getattr(proof, k)))
                        for k in SCALAR_FIELDS])
    v = hs.squeeze()
    return np.stack([_bn254_words(c) for c in (alpha, beta, gamma, z, v)])


def verify_bn254_fs_poseidon(ctx, vk, fs_proof: PoseidonFsProof,
                             public_inputs=None) -> bool:
    """Replay the 254-bit Poseidon transcript on the host and run the two
    real-pairing checks."""
    ch = derive_bn254_challenges_host(ctx, list(vk), fs_proof.proof,
                                      fs_proof.nonce, public_inputs)
    return PB.verify_bn254(ctx, vk, fs_proof.proof, ch,
                           public_inputs=public_inputs)
