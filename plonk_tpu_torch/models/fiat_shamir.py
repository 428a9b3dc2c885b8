"""Round-phased Fiat–Shamir transform over a BLAKE2b transcript.

Port of `plonk_tpu/models/fiat_shamir.py`: the scaled, BN254 and toy
provers. The transcript is `hashlib` BLAKE2b on the host, between the
prover's stages:

    preamble:  label, protocol params, verification key, public nonce
    round 1:   absorb [a]_1 [b]_1 [c]_1            -> beta, gamma
    round 2:   absorb [z]_1                        -> alpha
    round 3:   absorb [t_lo]_1 [t_mid]_1 [t_hi]_1  -> z
    round 4:   absorb the 7 evaluations            -> v

Only public data enters the transcript; the verifier re-derives every
challenge from the proof. Bytes absorbed, and so the challenges and
proofs, equal the JAX package's.

Challenge admissibility, as in the JAX package: beta/gamma that make a
permutation denominator vanish (the reference's zero-remainder abort,
src/plonk.h:506-510) make the prover bump a public retry nonce, absorbed
in the preamble and shipped with the proof; z with z^n == 1 and zero
challenges are re-sampled inside the squeeze on both sides.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops.curve import G1
from ..utils.params import BN254_FR
from .plonk import SCALAR_FIELDS, Proof
from . import plonk_bn254 as PB
from . import plonk_scaled as PS


def _host(a) -> np.ndarray:
    """A tensor (on any device), numpy array or int as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
    return np.asarray(a)


def _array_bytes(a) -> bytes:
    """Canonical serialization of an integer array: an ndim-and-shape
    header of <u4 words, then the values as <u8 words (bools as 0/1), so a
    0-d value and a (1,) array hash differently."""
    arr = _host(a)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint64)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"transcript absorbs integers, got {arr.dtype}")
    arr = arr.astype("<u8", casting="unsafe")
    header = np.asarray([arr.ndim] + list(arr.shape), dtype="<u4").tobytes()
    return header + arr.tobytes()


def point_bytes(pt) -> bytes:
    """Canonical G1/G2 serialization of the full coordinate arrays."""
    out = _array_bytes(pt.x) + _array_bytes(pt.y)
    if hasattr(pt, "inf"):
        out += _array_bytes(pt.inf)
    return out


class Transcript:
    """Append-only BLAKE2b transcript; squeezes field elements with
    deterministic, counter-keyed rejection."""

    def __init__(self, label: bytes, p: int):
        self.h = hashlib.blake2b(label, digest_size=32)
        self.p = p
        self.counter = 0

    def absorb_bytes(self, tag: bytes, data: bytes):
        self.h.update(len(tag).to_bytes(2, "little") + tag)
        self.h.update(len(data).to_bytes(8, "little") + data)

    def absorb_scalars(self, tag: bytes, xs):
        self.absorb_bytes(tag, _array_bytes(xs))

    def absorb_point(self, tag: bytes, pt):
        self.absorb_bytes(tag, point_bytes(pt))

    def squeeze(self, predicate=None) -> int:
        """One field element; re-sample until `predicate(v)` holds
        (default: v != 0)."""
        if predicate is None:
            predicate = lambda v: v != 0
        while True:
            st = self.h.copy()
            st.update(b"squeeze" + self.counter.to_bytes(4, "little"))
            self.counter += 1
            v = int.from_bytes(st.digest(), "little") % self.p
            if predicate(v):
                return v


def _preamble(label: bytes, pp, n: int, vk_points, nonce: int,
              public_inputs=None) -> Transcript:
    r = pp.field.p
    t = Transcript(label, r)
    t.absorb_scalars(b"params", np.asarray(
        [r % (1 << 32), r >> 32, n, pp.k1, pp.k2, pp.omega % r],
        dtype=np.uint64))
    for i, pt in enumerate(vk_points):
        t.absorb_point(b"vk%d" % i, pt)
    if public_inputs is not None:
        t.absorb_scalars(b"pi", _host(public_inputs))
    t.absorb_scalars(b"nonce", np.asarray([nonce], dtype=np.uint32))
    return t


def _not_in_domain(p: int, n: int):
    """z must satisfy z != 0 and z^n != 1 (z not in H)."""
    return lambda v: v != 0 and pow(v, n, p) != 1


def _eval_words(proof) -> np.ndarray:
    """The seven evaluations, stacked in transcript order."""
    return np.stack([_host(getattr(proof, k)) for k in SCALAR_FIELDS])


def _derive_from_proof(label: bytes, pp, n: int, vk_points, proof,
                       nonce: int, public_inputs=None) -> np.ndarray:
    """The verifier side: replay the transcript from the proof's points
    and evaluations. Returns [alpha beta gamma z v] (standard form)."""
    t = _preamble(label, pp, n, vk_points, nonce, public_inputs)
    t.absorb_point(b"a", proof.a_s)
    t.absorb_point(b"b", proof.b_s)
    t.absorb_point(b"c", proof.c_s)
    beta = t.squeeze()
    gamma = t.squeeze()
    t.absorb_point(b"z", proof.z_s)
    alpha = t.squeeze()
    t.absorb_point(b"t_lo", proof.t_lo_s)
    t.absorb_point(b"t_mid", proof.t_mid_s)
    t.absorb_point(b"t_hi", proof.t_hi_s)
    z = t.squeeze(_not_in_domain(t.p, n))
    t.absorb_scalars(b"evals", _eval_words(proof))
    v = t.squeeze()
    return np.array([alpha, beta, gamma, z, v], dtype=np.uint32)


class FsProof(NamedTuple):
    proof: object          # models.plonk.Proof
    nonce: int             # public retry counter (absorbed in preamble)
    challenge: np.ndarray  # [alpha beta gamma z v], derived


def _points(cms: G1) -> list:
    """A (..., k) G1 batch as a list of k points of shape (...), on its
    device."""
    return [G1(cms.x[..., i], cms.y[..., i], cms.inf[..., i])
            for i in range(cms.x.shape[-1])]


class ScaledFsProver:
    """Non-interactive scaled prover: the window table, verifying key and
    circuit tables are made once; each proof runs the four prover stages
    of plonk_scaled on the context's device, each committing its own
    polynomials through K2 (B = 3, 1, 3, 2), and hashes on the host in
    between. Usage:

        fs = ScaledFsProver(ctx, selectors, copies)
        out, diags = fs.prove(a_w, b_w, c_w, rand9)
        assert verify_scaled_fs(ctx, fs.vk, out)
    """

    def __init__(self, ctx, selectors, copies,
                 label: bytes = b"tpu-plonk-fs-v2", prims=None):
        self.ctx = ctx
        self.label = label
        self.vk = PS.make_vk_scaled(ctx, selectors, copies)
        self._vk_points = list(self.vk)
        base = prims if prims is not None else PS._auto_prims(ctx)
        self._pre = PS.precompute_circuit(ctx, selectors, copies, base)
        self._prims = base._replace(
            commit_many=PS.table_commit(ctx, PS.fixed_base_table(ctx)))

    def _encode(self, ch_std) -> list:
        """Standard-form challenges -> Montgomery 0-d tensors."""
        ctx = self.ctx
        ch = ctx.Fr.encode(PS._as_words(ch_std, ctx.device))
        return [ch[i] for i in range(len(ch_std))]

    def prove(self, a_w, b_w, c_w, rand9, public_inputs=None,
              max_retries: int = 32):
        """Returns (FsProof, ScaledDiagnostics). Nonces 0 .. max_retries - 1
        are tried for an admissible beta/gamma; RuntimeError if none is."""
        ctx, prims = self.ctx, self._prims
        Fr = ctx.Fr
        n = ctx.n
        commit = lambda polys: prims.commit_many(ctx, polys)
        st = PS._stage_prep(ctx, a_w, b_w, c_w, rand9, prims, self._pre,
                            public_inputs)
        pt1 = _points(commit([st["a_x"], st["b_x"], st["c_x"]]))

        for nonce in range(max_retries):
            t = _preamble(self.label, ctx.params, n, self._vk_points, nonce,
                          public_inputs)
            for tag, pt in zip((b"a", b"b", b"c"), pt1):
                t.absorb_point(tag, pt)
            beta = t.squeeze()
            gamma = t.squeeze()
            beta_m, gamma_m = self._encode([beta, gamma])
            z_x, den_ok = PS._stage_grand_product(ctx, st, beta_m, gamma_m,
                                                  prims)
            if bool(den_ok):
                break
        else:
            raise RuntimeError(
                "no admissible beta/gamma in %d retries" % max_retries)

        (z_pt,) = _points(commit([z_x]))
        t.absorb_point(b"z", z_pt)
        alpha = t.squeeze()
        (alpha_m,) = self._encode([alpha])
        q3 = PS._stage_quotient(ctx, st, z_x, alpha_m, beta_m, gamma_m,
                                prims)
        pt3 = _points(commit([q3["t_lo_x"], q3["t_mid_x"], q3["t_hi_x"]]))
        for tag, pt in zip((b"t_lo", b"t_mid", b"t_hi"), pt3):
            t.absorb_point(tag, pt)
        zch = t.squeeze(_not_in_domain(t.p, n))
        # v depends on the evaluations, which do not depend on v: evaluate
        # with v = 1 (no commitment), absorb, then open with the real v
        ch = [alpha, beta, gamma, zch, 1]
        q5 = PS._stage_openings(ctx, st, q3, z_x, *self._encode(ch))
        t.absorb_scalars(b"evals", Fr.decode(torch.stack(
            [q5[k] for k in SCALAR_FIELDS])))
        ch[4] = t.squeeze()
        q5 = PS._stage_openings(ctx, st, q3, z_x, *self._encode(ch))
        pt4 = _points(commit([q5["w_z_x_quo"], q5["w_z_omega_x"]]))

        proof = Proof(
            a_s=pt1[0], b_s=pt1[1], c_s=pt1[2], z_s=z_pt,
            t_lo_s=pt3[0], t_mid_s=pt3[1], t_hi_s=pt3[2],
            w_z_s=pt4[0], w_z_omega_s=pt4[1],
            **{k: Fr.decode(q5[k]) for k in SCALAR_FIELDS})
        diags = PS.ScaledDiagnostics(
            satisfied=st["satisfied"], t_tail_zero=q3["t_tail_zero"],
            w_z_rem_zero=q5["rem1"] == 0, w_zw_rem_zero=q5["rem2"] == 0)
        return (FsProof(proof=proof, nonce=nonce,
                        challenge=np.array(ch, dtype=np.uint32)), diags)


def verify_scaled_fs(ctx, vk, fs_proof: FsProof,
                     label: bytes = b"tpu-plonk-fs-v2",
                     public_inputs=None) -> bool:
    """Re-derive the challenges from the transcript (on the host) and run
    the two-pairing check. Any tampered commitment or evaluation changes
    the derived challenges and the pairing identity."""
    ch = _derive_from_proof(label, ctx.params, ctx.n, list(vk),
                            fs_proof.proof, fs_proof.nonce, public_inputs)
    return PS.verify_scaled(ctx, vk, fs_proof.proof, ch,
                            public_inputs=public_inputs)


# ---------------- BN254 prover (production curve) ---------------------
#
# The same round-phased transcript over 254-bit challenges, carried as
# (16,) 16-bit-word arrays: commitments are absorbed as their (16,) x and
# y words and 0-d infinity flag, the evaluations as one (7, 16) array, so
# the bytes equal the JAX package's.

BN254_LABEL = b"tpu-plonk-bn254-fs-v1"


def _bn254_words(v: int) -> np.ndarray:
    return np.array([(int(v) >> (16 * k)) & 0xFFFF for k in range(16)],
                    dtype=np.uint32)


def _bn254_preamble(label: bytes, ctx, vk_points, nonce: int,
                    public_inputs=None) -> Transcript:
    r = BN254_FR.p
    t = Transcript(label, r)
    t.absorb_scalars(b"params", np.concatenate(
        [_bn254_words(r), _bn254_words(ctx.n), _bn254_words(ctx.k1),
         _bn254_words(ctx.k2), _bn254_words(ctx.omega)]))
    for i, pt in enumerate(vk_points):
        t.absorb_point(b"vk%d" % i, pt)
    if public_inputs is not None:
        t.absorb_scalars(b"pi", _host(public_inputs))
    t.absorb_scalars(b"nonce", np.asarray([nonce], dtype=np.uint32))
    return t


def _bn254_derive_from_proof(label: bytes, ctx, vk_points, proof,
                             nonce: int, public_inputs=None) -> np.ndarray:
    """The verifier side: replay the transcript from the proof. Returns
    the (5, 16) standard-form challenge words [alpha beta gamma z v]."""
    t = _bn254_preamble(label, ctx, vk_points, nonce, public_inputs)
    t.absorb_point(b"a", proof.a_s)
    t.absorb_point(b"b", proof.b_s)
    t.absorb_point(b"c", proof.c_s)
    beta = t.squeeze()
    gamma = t.squeeze()
    t.absorb_point(b"z", proof.z_s)
    alpha = t.squeeze()
    t.absorb_point(b"t_lo", proof.t_lo_s)
    t.absorb_point(b"t_mid", proof.t_mid_s)
    t.absorb_point(b"t_hi", proof.t_hi_s)
    z = t.squeeze(_not_in_domain(t.p, ctx.n))
    t.absorb_scalars(b"evals", _eval_words(proof))
    v = t.squeeze()
    return np.stack([_bn254_words(c) for c in (alpha, beta, gamma, z, v)])


class _BN254Stages:
    """What both BN254 FS provers share: the prims (default
    PB._local_prims: commitments through the window table, K4 on the
    card, or PB._commit_many, as PB.use_bn254_fixed_base says), the
    verifying key and the circuit tables, made once."""

    def __init__(self, ctx, selectors, copies, prims=None):
        self.ctx = ctx
        self._prims = prims if prims is not None else PB._local_prims(ctx)
        self.vk = PB.make_vk_bn254(ctx, selectors, copies,
                                   prims=self._prims)
        self._vk_points = list(self.vk)
        self._pre = PB.precompute_bn254(ctx, selectors, copies, self._prims)

    def _commit(self, polys) -> list:
        """One commit_many of the polynomials -> standard-form points (of
        the polynomials' batch shape)."""
        Fq = self.ctx.Fq
        cms = self._prims.commit_many(polys)
        xs, ys = Fq.decode(cms.x), Fq.decode(cms.y)
        return [PB.BigG1Affine(xs[..., i, :], ys[..., i, :], cms.inf[..., i])
                for i in range(len(polys))]

    def _proof(self, pts, q5) -> PB.BN254Proof:
        """The nine points in proof order and the evaluations of q5."""
        return PB.BN254Proof(*pts, *self.ctx.Fr.decode(torch.stack(
            [q5[k] for k in SCALAR_FIELDS])).unbind(0))


class BN254FsProver(_BN254Stages):
    """Non-interactive BN254 prover: each proof runs the four stages of
    plonk_bn254 on the context's device, each committing its own
    polynomials (B = 3, 1, 3, 2: one K4 launch each on the table route),
    and hashes on the host in
    between. Usage:

        fs = BN254FsProver(ctx, selectors, copies)
        out, diags = fs.prove(a_w, b_w, c_w, rand9)
        assert verify_bn254_fs(ctx, fs.vk, out)
    """

    def __init__(self, ctx, selectors, copies, label: bytes = BN254_LABEL,
                 prims=None):
        super().__init__(ctx, selectors, copies, prims)
        self.label = label

    def _encode(self, ch_std) -> list:
        """Standard-form challenges -> Montgomery (16,) tensors."""
        ctx = self.ctx
        ch = ctx.Fr.encode(PB._as_words(
            np.stack([_bn254_words(c) for c in ch_std]), ctx.device))
        return list(ch.unbind(0))

    def prove(self, a_w, b_w, c_w, rand9, public_inputs=None,
              max_retries: int = 32):
        """Returns (FsProof, BN254Diagnostics). Nonces 0 .. max_retries - 1
        are tried for an admissible beta/gamma; RuntimeError if none is."""
        ctx, prims = self.ctx, self._prims
        Fr = ctx.Fr
        st = PB._stage_prep(ctx, a_w, b_w, c_w, rand9, prims, self._pre,
                            public_inputs)
        pt1 = self._commit([st["a_x"], st["b_x"], st["c_x"]])

        for nonce in range(max_retries):
            t = _bn254_preamble(self.label, ctx, self._vk_points, nonce,
                                public_inputs)
            for tag, pt in zip((b"a", b"b", b"c"), pt1):
                t.absorb_point(tag, pt)
            beta = t.squeeze()
            gamma = t.squeeze()
            beta_m, gamma_m = self._encode([beta, gamma])
            z_x, den_ok = PB._stage_grand_product(ctx, st, beta_m, gamma_m,
                                                  prims)
            if bool(den_ok):
                break
        else:
            raise RuntimeError(
                "no admissible beta/gamma in %d retries" % max_retries)

        (z_pt,) = self._commit([z_x])
        t.absorb_point(b"z", z_pt)
        alpha = t.squeeze()
        (alpha_m,) = self._encode([alpha])
        q3 = PB._stage_quotient(ctx, st, z_x, alpha_m, beta_m, gamma_m,
                                prims)
        pt3 = self._commit([q3["t_lo_x"], q3["t_mid_x"], q3["t_hi_x"]])
        for tag, pt in zip((b"t_lo", b"t_mid", b"t_hi"), pt3):
            t.absorb_point(tag, pt)
        zch = t.squeeze(_not_in_domain(t.p, ctx.n))
        # v depends on the evaluations, which do not depend on v: evaluate
        # with v = 1 (no commitment), absorb, then open with the real v
        ch = [alpha, beta, gamma, zch, 1]
        q5 = PB._stage_openings(ctx, st, q3, z_x, *self._encode(ch))
        t.absorb_scalars(b"evals", Fr.decode(torch.stack(
            [q5[k] for k in SCALAR_FIELDS])))
        ch[4] = t.squeeze()
        q5 = PB._stage_openings(ctx, st, q3, z_x, *self._encode(ch))
        pt4 = self._commit([q5["w_z_x_quo"], q5["w_z_omega_x"]])

        proof = self._proof(pt1 + [z_pt] + pt3 + pt4, q5)
        diags = PB.BN254Diagnostics(
            satisfied=st["satisfied"], t_tail_zero=q3["t_tail_zero"],
            w_z_rem_zero=q5["rem1"], w_zw_rem_zero=q5["rem2"])
        return (FsProof(proof=proof, nonce=nonce,
                        challenge=np.stack([_bn254_words(c) for c in ch])),
                diags)


def verify_bn254_fs(ctx, vk, fs_proof: FsProof, label: bytes = BN254_LABEL,
                    public_inputs=None) -> bool:
    """Re-derive the challenges from the transcript (on the host) and run
    the two real-pairing checks. Any tampered commitment or evaluation
    changes the derived challenges and the pairing identity."""
    ch = _bn254_derive_from_proof(label, ctx, list(vk), fs_proof.proof,
                                  fs_proof.nonce, public_inputs)
    return PB.verify_bn254(ctx, vk, fs_proof.proof, ch,
                           public_inputs=public_inputs)


# ---------------- toy prover (whole-prover replay) ----------------------
#
# Round-k outputs depend only on challenges derived before round k, so
# replaying the whole toy prover as each challenge arrives gives a
# transcript-consistent final proof.


def _toy_vk_points(vk) -> list:
    return [vk.q_m_s, vk.q_l_s, vk.q_r_s, vk.q_o_s, vk.q_c_s,
            vk.s_sigma_1_s, vk.s_sigma_2_s, vk.s_sigma_3_s]


def prove_fs(ctx, cons, asg, rand9, label: bytes = b"tpu-plonk-fs-v2",
             max_retries: int = 32):
    """Non-interactive toy prover (fixed SRS, standard dialect). Returns
    (FsProof, Diagnostics)."""
    from .plonk import prove
    from .verifier import make_verification_key
    r = ctx.params.field.p
    n = len(cons.c_a)
    vk_points = _toy_vk_points(make_verification_key(ctx, cons))

    def run(ch):
        return prove(ctx, cons, asg, ch, rand9, dialect="standard")

    for nonce in range(max_retries):
        ch = np.array([1, 1, 1, 1, 1], dtype=np.uint32)
        proof, diags = run(ch)                      # round 1 commitments
        t = _preamble(label, ctx.params, n, vk_points, nonce)
        t.absorb_point(b"a", proof.a_s)
        t.absorb_point(b"b", proof.b_s)
        t.absorb_point(b"c", proof.c_s)
        ch[1] = t.squeeze()                         # beta
        ch[2] = t.squeeze()                         # gamma
        proof, diags = run(ch)                      # round 2 commitment
        if not bool(diags.t_rem_zero):
            continue                                # vanishing denominator
        t.absorb_point(b"z", proof.z_s)
        ch[0] = t.squeeze()                         # alpha
        proof, diags = run(ch)                      # round 3 commitments
        t.absorb_point(b"t_lo", proof.t_lo_s)
        t.absorb_point(b"t_mid", proof.t_mid_s)
        t.absorb_point(b"t_hi", proof.t_hi_s)
        ch[3] = t.squeeze(_not_in_domain(r, n))     # z
        proof, diags = run(ch)                      # round 4 evaluations
        t.absorb_scalars(b"evals", _eval_words(proof))
        ch[4] = t.squeeze()                         # v
        proof, diags = run(ch)                      # final proof
        if bool(diags.all_ok()):
            return FsProof(proof=proof, nonce=nonce, challenge=ch), diags
    raise RuntimeError("no admissible challenges in %d retries"
                       % max_retries)


def verify_fs(ctx, cons, fs_proof: FsProof,
              label: bytes = b"tpu-plonk-fs-v2") -> bool:
    from .verifier import make_verification_key, verify
    vk = make_verification_key(ctx, cons)
    ch = _derive_from_proof(label, ctx.params, len(cons.c_a),
                            _toy_vk_points(vk), fs_proof.proof,
                            fs_proof.nonce)
    return verify(ctx, vk, fs_proof.proof, ch)
