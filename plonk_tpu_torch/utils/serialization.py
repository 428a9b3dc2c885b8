"""Canonical bytes for proofs and SRSs: port of
`plonk_tpu/utils/serialization.py`, byte for byte, so each package loads
what the other wrote.

Format (little-endian):
  proof:  magic "TPLK" | u16 version | u16 coord_bytes
          9 points (x, y as coord_bytes each + 1 inf byte)
          7 scalars (coord_bytes each)
  srs:    magic "TSRS" | u16 version | u16 coord_bytes | u64 length
          length points | g2_1 (x, y) | g2_s (x, y)
  BN254 proof: magic "TPB2" | u16 version | u16 coord_bytes (32)
          9 points (x, y, inf byte) | 7 scalars, each value the integer
          of its (16,) 16-bit words.

Points and scalars hold the words the provers emit (Montgomery words for
the scaled curve's coordinates). A loader puts the values on `device`
(default: the CUDA card; pass device="cpu" for the CPU).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..models.plonk import POINT_FIELDS, SCALAR_FIELDS, Proof
from ..models.plonk_bn254 import BigG1Affine, BN254Proof
from ..models.srs import SRS
from ..ops.curve import G1, G2
from .kernels import resolve_device

_VERSION = 1
I64 = torch.int64


def _coord_bytes(p: int) -> int:
    return max(1, (p.bit_length() + 7) // 8)


def _int(a) -> int:
    return int(a.item() if isinstance(a, torch.Tensor) else np.asarray(a))


def _header(data: bytes, magic: bytes, what: str, fmt: str) -> tuple:
    """Check the magic and version; the header's other fields."""
    if data[:4] != magic:
        raise ValueError(f"bad {what} magic")
    fields = struct.unpack(fmt, data[4:4 + struct.calcsize(fmt)])
    if fields[0] != _VERSION:
        raise ValueError(f"{what} version {fields[0]}, want {_VERSION}")
    return fields[1:]


class _Reader:
    """Consumes fixed-width little-endian integers from `data`."""

    def __init__(self, data: bytes, off: int, what: str):
        self.data, self.off, self.what = data, off, what

    def int(self, nbytes: int) -> int:
        if self.off + nbytes > len(self.data):
            raise ValueError(f"truncated {self.what}")
        v = int.from_bytes(self.data[self.off:self.off + nbytes], "little")
        self.off += nbytes
        return v

    def end(self):
        if self.off != len(self.data):
            raise ValueError(f"trailing bytes in {self.what}")


def proof_to_bytes(proof: Proof, q: int, r: int) -> bytes:
    cb = max(_coord_bytes(q), _coord_bytes(r))
    out = [b"TPLK", struct.pack("<HH", _VERSION, cb)]
    for name in POINT_FIELDS:
        pt = getattr(proof, name)
        out.append(_int(pt.x).to_bytes(cb, "little"))
        out.append(_int(pt.y).to_bytes(cb, "little"))
        out.append(bytes([int(bool(_int(pt.inf)))]))
    for name in SCALAR_FIELDS:
        out.append(_int(getattr(proof, name)).to_bytes(cb, "little"))
    return b"".join(out)


def proof_from_bytes(data: bytes, device=None) -> Proof:
    (cb,) = _header(data, b"TPLK", "proof", "<HH")
    dev = resolve_device(device)
    rd = _Reader(data, 8, "proof")
    word = lambda: torch.tensor(rd.int(cb), dtype=I64, device=dev)
    vals = {}
    for name in POINT_FIELDS:
        x, y = word(), word()
        vals[name] = G1(x, y, torch.tensor(bool(rd.int(1)), device=dev))
    for name in SCALAR_FIELDS:
        vals[name] = word()
    rd.end()
    return Proof(**vals)


def srs_to_bytes(srs: SRS, q: int) -> bytes:
    cb = _coord_bytes(q)
    n = srs.length
    out = [b"TSRS", struct.pack("<HHQ", _VERSION, cb, n)]
    xs, ys, infs = (t.cpu().numpy() for t in srs.g1s)
    for i in range(n):
        out.append(int(xs[i]).to_bytes(cb, "little"))
        out.append(int(ys[i]).to_bytes(cb, "little"))
        out.append(bytes([int(bool(infs[i]))]))
    for pt in (srs.g2_1, srs.g2_s):
        out.append(_int(pt.x).to_bytes(cb, "little"))
        out.append(_int(pt.y).to_bytes(cb, "little"))
    return b"".join(out)


def srs_from_bytes(data: bytes, mode: str = "unknown", device=None) -> SRS:
    cb, n = _header(data, b"TSRS", "srs", "<HHQ")
    dev = resolve_device(device)
    rd = _Reader(data, 16, "srs")
    xs = np.zeros(n, dtype=np.int64)
    ys = np.zeros(n, dtype=np.int64)
    infs = np.zeros(n, dtype=bool)
    for i in range(n):
        xs[i], ys[i], infs[i] = rd.int(cb), rd.int(cb), bool(rd.int(1))
    g2 = [G2(torch.tensor(rd.int(cb), dtype=I64, device=dev),
             torch.tensor(rd.int(cb), dtype=I64, device=dev))
          for _ in range(2)]
    rd.end()
    g1s = G1(*(torch.as_tensor(a, device=dev) for a in (xs, ys, infs)))
    return SRS(g1s=g1s, g2_1=g2[0], g2_s=g2[1], mode=mode)


# ---------------- BN254 (16-bit words) ----------------

def _from_words(w) -> int:
    w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    v = 0
    for k in range(w.shape[-1] - 1, -1, -1):
        v = (v << 16) | int(w[k])
    return v


def _to_words(v: int, n_words: int) -> list:
    return [(v >> (16 * k)) & 0xFFFF for k in range(n_words)]


def bn254_proof_to_bytes(proof: BN254Proof) -> bytes:
    cb = 32
    out = [b"TPB2", struct.pack("<HH", _VERSION, cb)]
    for name in POINT_FIELDS:
        pt = getattr(proof, name)
        out.append(_from_words(pt.x).to_bytes(cb, "little"))
        out.append(_from_words(pt.y).to_bytes(cb, "little"))
        out.append(bytes([int(bool(_int(pt.inf)))]))
    for name in SCALAR_FIELDS:
        out.append(_from_words(getattr(proof, name)).to_bytes(cb, "little"))
    return b"".join(out)


def bn254_proof_from_bytes(data: bytes, device=None) -> BN254Proof:
    (cb,) = _header(data, b"TPB2", "bn254 proof", "<HH")
    dev = resolve_device(device)
    nw = cb // 2
    rd = _Reader(data, 8, "bn254 proof")
    words = lambda: torch.tensor(_to_words(rd.int(cb), nw), dtype=I64,
                                 device=dev)
    vals = {}
    for name in POINT_FIELDS:
        x, y = words(), words()
        vals[name] = BigG1Affine(x, y,
                                 torch.tensor(bool(rd.int(1)), device=dev))
    for name in SCALAR_FIELDS:
        vals[name] = words()
    rd.end()
    return BN254Proof(**vals)
