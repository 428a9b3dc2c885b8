"""Carry the JAX package's setup artefacts and proofs across.

The SRS and the fixed-base window table play the part that weights play
in a model: made once, then fed to every proof. These helpers turn the
JAX package's arrays (numpy, uint32 words and bool flags, including the
`x/y/inf` arrays of a `fbtable_*.npz` cache file) into this package's
int64 tensors, and SRSs, circuits (the toy `Constraints`), proofs (the
Fiat–Shamir ones with their nonce and challenge) and the toy prover's
diagnostics both ways. Words keep their form: Montgomery
words for the scaled curve and BN254, standard words for the toy fields.
Nothing here imports JAX: any array that `np.asarray` accepts will do.
Leading axes carry over: a proof or diagnostics from JAX's vmapped
provers (every leaf with a leading batch axis B) becomes the port's
stacked proof (the layout of `stack_proofs`) or (B,) flags.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import plonk_bn254 as PB
from ..models import plonk_scaled as PS
from ..models.constraints import Constraints
from ..models.fiat_shamir import FsProof
from ..models.fs_poseidon import PoseidonFsProof
from ..models.plonk import POINT_FIELDS, SCALAR_FIELDS, Diagnostics, Proof
from ..models.srs import SRS
from ..ops.curve import G1, G2
from ..ops.bigcurve import BigFixedBaseTable
from ..ops.fixed_base import FixedBaseTable


def _words(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


def _flags(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(bool), device=device)


def srs_from_numpy(g1_x, g1_y, g1_inf, g2_1, g2_s, mode: str,
                   device) -> SRS:
    """SRS from G1 coordinate/flag arrays and the two G2 points as (x, y)
    pairs, in the field's words."""
    return SRS(g1s=G1(_words(g1_x, device), _words(g1_y, device),
                      _flags(g1_inf, device)),
               g2_1=G2(_words(g2_1[0], device), _words(g2_1[1], device)),
               g2_s=G2(_words(g2_s[0], device), _words(g2_s[1], device)),
               mode=mode)


def srs_to_numpy(srs) -> dict:
    """The arguments of srs_from_numpy (uint32 words, bool flags) from any
    SRS whose points have .x/.y(/.inf): this package's, or a JAX SRS."""
    arr = lambda a: np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                               else a)
    return dict(g1_x=arr(srs.g1s.x).astype(np.uint32),
                g1_y=arr(srs.g1s.y).astype(np.uint32),
                g1_inf=arr(srs.g1s.inf).astype(bool),
                g2_1=(arr(srs.g2_1.x).astype(np.uint32),
                      arr(srs.g2_1.y).astype(np.uint32)),
                g2_s=(arr(srs.g2_s.x).astype(np.uint32),
                      arr(srs.g2_s.y).astype(np.uint32)),
                mode=srs.mode)


_CONSTRAINT_FIELDS = ("q_l", "q_r", "q_o", "q_m", "q_c", "c_a", "c_b", "c_c")


def constraints_from_numpy(cons) -> Constraints:
    """This package's Constraints from any object with the selector and
    copy arrays q_l .. q_c, c_a .. c_c (e.g. a JAX Constraints)."""
    return Constraints(**{f: np.array(getattr(cons, f), dtype=np.int64)
                          for f in _CONSTRAINT_FIELDS})


def constraints_to_numpy(cons: Constraints) -> dict:
    """The selector and copy arrays by field name (int64, the JAX
    package's dtype), ready for either package's Constraints(**d)."""
    return {f: np.array(getattr(cons, f), dtype=np.int64)
            for f in _CONSTRAINT_FIELDS}


def diagnostics_from_numpy(diags, device) -> Diagnostics:
    """Diagnostics of bool tensors from any object with its field names."""
    return Diagnostics(*(_flags(getattr(diags, f), device)
                         for f in Diagnostics._fields))


def diagnostics_to_numpy(diags: Diagnostics) -> Diagnostics:
    """Diagnostics of numpy bool arrays."""
    return Diagnostics(*(d.cpu().numpy().astype(bool) for d in diags))


def table_from_numpy(x, y, inf, window_bits: int,
                     device) -> FixedBaseTable:
    """FixedBaseTable from (n_windows, n_buckets, L) arrays."""
    return FixedBaseTable(x=_words(x, device), y=_words(y, device),
                          inf=_flags(inf, device),
                          window_bits=int(window_bits))


def proof_from_numpy(proof, device) -> Proof:
    """Proof of tensors from any object with the Proof field names whose
    points have .x/.y/.inf (e.g. a JAX Proof, or proof_to_numpy's
    output)."""
    fields = {}
    for name in POINT_FIELDS:
        pt = getattr(proof, name)
        fields[name] = G1(_words(pt.x, device), _words(pt.y, device),
                          _flags(pt.inf, device))
    for name in SCALAR_FIELDS:
        fields[name] = _words(getattr(proof, name), device)
    return Proof(**fields)


def proof_to_numpy(proof: Proof) -> Proof:
    """Proof of numpy arrays in the JAX package's dtypes (uint32 words,
    bool flags)."""
    fields = {}
    for name in POINT_FIELDS:
        pt = getattr(proof, name)
        fields[name] = G1(pt.x.cpu().numpy().astype(np.uint32),
                          pt.y.cpu().numpy().astype(np.uint32),
                          pt.inf.cpu().numpy().astype(bool))
    for name in SCALAR_FIELDS:
        fields[name] = getattr(proof, name).cpu().numpy().astype(np.uint32)
    return Proof(**fields)


def _fs_fields(fs, proof) -> dict:
    return dict(proof=proof, nonce=int(fs.nonce),
                challenge=np.asarray(fs.challenge).astype(np.uint32))


def fs_proof_from_numpy(fs, device) -> FsProof:
    """FsProof of tensors from any object with proof/nonce/challenge (a
    JAX FsProof of a scaled proof); nonce and challenge kept."""
    return FsProof(**_fs_fields(fs, proof_from_numpy(fs.proof, device)))


def poseidon_fs_proof_from_numpy(fs, device) -> PoseidonFsProof:
    """PoseidonFsProof of tensors from a JAX PoseidonFsProof (or any object
    with its fields); nonce and challenge kept."""
    return PoseidonFsProof(**_fs_fields(fs, proof_from_numpy(fs.proof,
                                                             device)))


def fs_proof_to_numpy(fs):
    """An FsProof or PoseidonFsProof with its proof as numpy arrays in the
    JAX package's dtypes (proof_to_numpy), of the same type."""
    return type(fs)(**_fs_fields(fs, proof_to_numpy(fs.proof)))


# ---- BN254 ----

def bn254_srs_from_numpy(x, y, inf, g2_1x, g2_1y, g2_sx, g2_sy, length,
                         device):
    """BN254SRS from the arrays of the JAX package's SRS (the
    `bn254_srs_n{n}_s{secret}.npz` layout: G1 x/y (L, 16) Montgomery
    words, inf (L,), each G2 coordinate an Fq2 as a (2, 16) array)."""
    return PB.BN254SRS(g1s=PB.BigG1Affine(_words(x, device), _words(y, device),
                                          _flags(inf, device)),
                       g2_1x=_words(g2_1x, device),
                       g2_1y=_words(g2_1y, device),
                       g2_sx=_words(g2_sx, device),
                       g2_sy=_words(g2_sy, device), length=int(length))


def big_table_from_numpy(x, y, inf, window_bits: int, device):
    """BigFixedBaseTable from (W, nb, L, 16) / (W, nb, L) arrays (the
    `bn254_fbtbl_*.npz` x/y/inf)."""
    return BigFixedBaseTable(x=_words(x, device), y=_words(y, device),
                             inf=_flags(inf, device),
                             window_bits=int(window_bits))


def scaled_diagnostics_from_numpy(diags, device) -> PS.ScaledDiagnostics:
    """ScaledDiagnostics of bool tensors from any object with its four
    flags (a JAX ScaledDiagnostics: 0-d flags, or (B,) from vmap)."""
    return PS.ScaledDiagnostics(*(_flags(getattr(diags, k), device)
                                  for k in PS.ScaledDiagnostics._fields))


def bn254_diagnostics_from_numpy(diags, device) -> PB.BN254Diagnostics:
    """BN254Diagnostics of bool tensors from any object with its four
    flags (a JAX BN254Diagnostics, vmapped or not)."""
    return PB.BN254Diagnostics(*(_flags(getattr(diags, k), device)
                                 for k in PB.BN254Diagnostics._fields))


def bn254_proof_from_numpy(proof, device):
    """BN254Proof of tensors from any object with its field names whose
    points have .x/.y/.inf (a JAX BN254Proof, or bn254_proof_to_numpy's
    output)."""
    fields = {}
    for name in PB.POINT_FIELDS:
        pt = getattr(proof, name)
        fields[name] = PB.BigG1Affine(_words(pt.x, device),
                                      _words(pt.y, device),
                                      _flags(pt.inf, device))
    for name in PB.SCALAR_FIELDS:
        fields[name] = _words(getattr(proof, name), device)
    return PB.BN254Proof(**fields)


def bn254_proof_to_numpy(proof):
    """BN254Proof of numpy arrays in the JAX package's dtypes."""
    u32 = lambda t: t.cpu().numpy().astype(np.uint32)
    fields = {}
    for name in PB.POINT_FIELDS:
        pt = getattr(proof, name)
        fields[name] = PB.BigG1Affine(u32(pt.x), u32(pt.y),
                                      pt.inf.cpu().numpy().astype(bool))
    for name in PB.SCALAR_FIELDS:
        fields[name] = u32(getattr(proof, name))
    return PB.BN254Proof(**fields)


def bn254_fs_proof_from_numpy(fs, device) -> FsProof:
    """FsProof of tensors from a JAX FsProof of a BN254 proof (or any
    object with proof/nonce/challenge); nonce and (5, 16) challenge
    kept."""
    return FsProof(**_fs_fields(fs, bn254_proof_from_numpy(fs.proof,
                                                           device)))


def bn254_poseidon_fs_proof_from_numpy(fs, device) -> PoseidonFsProof:
    """PoseidonFsProof of tensors from a JAX PoseidonFsProof of a BN254
    proof (or any object with its fields); nonce and challenge kept."""
    return PoseidonFsProof(**_fs_fields(fs, bn254_proof_from_numpy(
        fs.proof, device)))


def bn254_fs_proof_to_numpy(fs):
    """A BN254 FsProof or PoseidonFsProof with its proof as numpy arrays
    in the JAX package's dtypes, of the same type."""
    return type(fs)(**_fs_fields(fs, bn254_proof_to_numpy(fs.proof)))
