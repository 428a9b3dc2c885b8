"""Multi-limb Montgomery field arithmetic (BN254-Fr and BN254-Fq).

Port of `plonk_tpu/ops/bigfield.py::BigMontField` and its transforms
`big_ntt`/`big_intt`. An element is a (..., limbs) tensor of 16-bit
words, little-endian, held in int64 on every device; R = 2^(16*limbs)
(2^256 for the BN254 fields). Every operation returns fully reduced
words, and fully reduced Montgomery words are unique, so they equal the
JAX package's uint32 words word for word.

Each operation runs over the whole limb axis, so one Montgomery product
is a few dozen PyTorch launches however wide the batch:

- the schoolbook product is one broadcast product (..., 16, 16) whose
  anti-diagonals are summed by a skew (pad, flatten, re-stride) and one
  sum: columns stay "relaxed" (wider than 16 bits, exact in int64);
- REDC is full width: m = T*n' mod R and V = T + m*p from the relaxed
  columns of T, then V's columns are folded to <= 2^16 and V/R is read
  off the top half (the bottom half of V is 0 mod R, so after folding it
  is either all zero or exactly R);
- an exact carry chain over 16-bit columns is one `cummax` over the
  positions that do not propagate a carry, not a ripple of slices.

Products of two words are < 2^32, a column of relaxed products < 2^57,
so no intermediate leaves int64. The broadcast product costs ~10 KB of
temporaries per element; callers chunk batches of millions of elements.

Constants (`const`, the modulus words) are tuples of Python ints; an
operation given one next to a tensor makes it a tensor on that tensor's
device (cached), so the same code serves the CPU and the card.
Reference behaviours kept: inv(0) = 0, pow(_, 0) = 1.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as TF

from ..utils.params import FieldParams
from .fused_ntt import _bitrev

I64 = torch.int64
_W = 16                      # word width in bits
_MASK = 0xFFFF


def _to_words(v: int, limbs: int) -> tuple:
    return tuple((v >> (_W * k)) & _MASK for k in range(limbs))


def _from_words(ws) -> int:
    v = 0
    for w in reversed([int(x) for x in ws]):
        v = (v << _W) | w
    return v


@functools.lru_cache(maxsize=4096)
def _const_tensor(words: tuple, device: str) -> torch.Tensor:
    return torch.tensor(words, dtype=I64, device=device)


def as_words(x, like: torch.Tensor) -> torch.Tensor:
    """A tensor operand as it is; a tuple of words as a (cached) tensor on
    `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return _const_tensor(tuple(int(w) for w in x), str(like.device))


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., k] = x[..., k-d], zero below; the top d columns drop."""
    L = x.shape[-1]
    if d >= L:
        return torch.zeros_like(x)
    return TF.pad(x[..., :L - d], (d, 0))


def _fold(s: torch.Tensor, bound: int):
    """Carry-fold relaxed columns until every column is <= 2^16; carries
    out of the top column are dropped (callers ensure they are zero or
    want the value mod R). Returns the folded columns."""
    while bound > _MASK + 1:
        s = (s & _MASK) + _shift_up(s >> _W, 1)
        bound = _MASK + (bound >> _W)
    return s


def _prop(s: torch.Tensor):
    """Exact carry propagation of columns in [0, 0x1FFFF] whose carries
    are 0 or 1. The carry out of column k is the carry generated at the
    last column j <= k that does not merely pass a carry on (its low word
    is not 0xFFFF, or it generates one itself), found with one cummax.
    Returns (16-bit words, carry out of the top column)."""
    L = s.shape[-1]
    lo = s & _MASK
    g = s >> _W
    pos = torch.arange(L, device=s.device)
    stop = (lo != _MASK) | (g != 0)
    last = torch.cummax(torch.where(stop, pos, -1), dim=-1).values
    c = torch.where(last >= 0, torch.gather(g, -1, last.clamp(min=0)), 0)
    return (lo + _shift_up(c, 1)) & _MASK, c[..., -1]


def _colsum(a: torch.Tensor, b: torch.Tensor, out_cols: int) -> torch.Tensor:
    """Anti-diagonal column sums of the partial products of a (..., La)
    and b (..., Lb): out[..., c] = sum_{i+j=c} a_i b_j, relaxed, truncated
    or zero-padded to out_cols. The skew: pad each product row to width
    Wd = La+Lb, flatten, and re-read with row stride Wd-1, which shifts
    row i right by i."""
    La, Lb = a.shape[-1], b.shape[-1]
    P = a[..., :, None] * b[..., None, :]             # (..., La, Lb)
    Wd = La + Lb
    flat = TF.pad(P, (0, La)).flatten(-2)             # (..., La*Wd)
    Q = flat[..., :La * (Wd - 1)].reshape(P.shape[:-2] + (La, Wd - 1))
    cols = Q.sum(-2)                                  # (..., La+Lb-1)
    n = cols.shape[-1]
    if out_cols <= n:
        return cols[..., :out_cols]
    return TF.pad(cols, (0, out_cols - n))


@dataclasses.dataclass(frozen=True)
class BigMontField:
    """Montgomery-form field over odd p with R = 2^(16*limbs).

    `limbs` is derived from p (16 for BN254) with a spare bit, as in the
    JAX package (whose `rolled` switch chooses between two XLA lowerings
    of the same product and has no counterpart here)."""
    params: FieldParams
    limbs: int = 0

    def __post_init__(self):
        L = self.limbs or -(-self.p.bit_length() // _W)
        if self.p.bit_length() == _W * L:
            L += 1  # keep a spare bit so a+b < 2p never overflows R
        object.__setattr__(self, "limbs", L)
        if self.p % 2 == 0:
            raise ValueError("BigMontField requires odd p")
        if self.p.bit_length() >= _W * L:
            raise ValueError("modulus does not fit the limb count")

    @property
    def p(self) -> int:
        return self.params.p

    @property
    def R(self) -> int:
        return 1 << (_W * self.limbs)

    @functools.cached_property
    def _p_words(self) -> tuple:
        return _to_words(self.p, self.limbs)

    @functools.cached_property
    def _rp_words(self) -> tuple:
        """R - p: adding it subtracts p mod R; the carry out is s >= p."""
        return _to_words(self.R - self.p, self.limbs)

    @functools.cached_property
    def _nprime_words(self) -> tuple:
        """-p^{-1} mod R (the full-width REDC factor)."""
        return _to_words((-pow(self.p, -1, self.R)) % self.R, self.limbs)

    @functools.cached_property
    def _e0_words(self) -> tuple:
        return _to_words(1, self.limbs)

    # ---- host-side encoding ----
    def encode_host(self, xs) -> np.ndarray:
        """Python ints (any shape) -> Montgomery words, int64 numpy."""
        arr = np.asarray(xs, dtype=object)
        flat = arr.reshape(-1)
        R, p = self.R, self.p
        out = np.empty((flat.shape[0], self.limbs), dtype=np.int64)
        for i, v in enumerate(flat):
            out[i] = _to_words((int(v) % p) * R % p, self.limbs)
        return out.reshape(arr.shape + (self.limbs,))

    def decode_host(self, words) -> np.ndarray:
        """Montgomery words -> Python-int numpy array (object dtype)."""
        a = np.asarray(words.cpu() if isinstance(words, torch.Tensor)
                       else words).astype(np.int64)
        flat = a.reshape(-1, self.limbs)
        Rinv = pow(self.R, -1, self.p)
        out = np.empty(flat.shape[0], dtype=object)
        for i, ws in enumerate(flat):
            out[i] = _from_words(ws) * Rinv % self.p
        return out.reshape(a.shape[:-1])

    def array(self, xs, device) -> torch.Tensor:
        return torch.as_tensor(self.encode_host(xs), device=device)

    def const(self, v: int) -> tuple:
        """Montgomery form of v as a tuple of words."""
        return _to_words((v % self.p) * self.R % self.p, self.limbs)

    def full(self, v: int, shape, device) -> torch.Tensor:
        return as_words(self.const(v), torch.empty(0, device=device)
                        ).expand(tuple(shape) + (self.limbs,))

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.limbs,), dtype=I64,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        return self.full(1, shape, device)

    # ---- arithmetic (Montgomery form in, Montgomery form out) ----
    def _csub_p(self, s: torch.Tensor) -> torch.Tensor:
        """s in [0, 2p) as exact 16-bit words -> s mod p."""
        d, ge = _prop(s + as_words(self._rp_words, s))
        return torch.where((ge == 1)[..., None], d, s)

    def _pair(self, a, b):
        if not isinstance(a, torch.Tensor):
            a = as_words(a, b)
        b = as_words(b, a)
        return torch.broadcast_tensors(a, b)

    def add(self, a, b) -> torch.Tensor:
        a, b = self._pair(a, b)
        s, _ = _prop(a + b)            # a + b < 2p < R: no overflow
        return self._csub_p(s)

    def sub(self, a, b) -> torch.Tensor:
        a, b = self._pair(a, b)
        # a - b = a + ~b + 1 mod R; the carry out says a >= b
        d, ge = _prop(a + (_MASK - b) + as_words(self._e0_words, a))
        d2, _ = _prop(d + as_words(self._p_words, d))      # wraps mod R
        return torch.where((ge == 1)[..., None], d, d2)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(-1)

    def eq(self, a, b) -> torch.Tensor:
        a, b = self._pair(a, b)
        return (a == b).all(-1)

    def mont_mul(self, a, b) -> torch.Tensor:
        """a * b * R^-1 mod p by full-width REDC (see the module notes)."""
        a, b = self._pair(a, b)
        L = self.limbs
        T = _colsum(a, b, 2 * L)                       # < 2^36 per column
        m = _colsum(T[..., :L], as_words(self._nprime_words, T), L)
        m, _ = _prop(_fold(m, L * L << 48))           # T*n' mod R
        V = T + _colsum(m, as_words(self._p_words, m), 2 * L)
        V = _fold(V, 2 * L << 32)                      # V = T + m*p < R^2
        # V's low half is 0 mod R and now at most (1 + 2^-16) R: it is R
        # exactly when any of its columns is nonzero
        carry = (V[..., :L] != 0).any(-1)
        hi = V[..., L:]
        hi = torch.cat([hi[..., :1] + carry[..., None], hi[..., 1:]], -1)
        r, _ = _prop(hi)                               # r < 2p
        return self._csub_p(r)

    mul = mont_mul

    def mul_many(self, pairs) -> list:
        """Independent products [a*b for (a, b) in pairs] in ONE
        mont_mul over the stacked operands: the launches of a product do
        not grow with its batch, so stacking cuts the launch count."""
        ops = [self._pair(a, b) for a, b in pairs]
        shape = torch.broadcast_shapes(*[a.shape for a, _ in ops])
        lhs = torch.stack([a.expand(shape) for a, _ in ops])
        rhs = torch.stack([b.expand(shape) for _, b in ops])
        return list(self.mont_mul(lhs, rhs).unbind(0))

    def square(self, a):
        return self.mont_mul(a, a)

    def encode(self, a) -> torch.Tensor:
        """Standard-form words -> Montgomery form."""
        return self.mont_mul(a, _to_words(self.R * self.R % self.p,
                                          self.limbs))

    def decode(self, a) -> torch.Tensor:
        return self.mont_mul(a, self._e0_words)

    # ---- exponentiation / inverse ----
    def pow_static(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a Python-int exponent, MSB first; pow(_, 0) = 1."""
        if e < 0:
            raise ValueError("negative exponent")
        if e == 0:
            return self.ones(a.shape[:-1], a.device).clone()
        acc = a
        for bit in bin(e)[3:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mont_mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inverse; inv(0) = 0."""
        return self.pow_static(a, self.p - 2)


# ---- big-field NTT (reshape-butterfly layout, element axis -2) ----

@functools.lru_cache(maxsize=None)
def _twiddle_words(p: int, w: int, n: int, limbs: int) -> np.ndarray:
    R = 1 << (_W * limbs)
    out = np.empty((n // 2, limbs), dtype=np.int64)
    cur = 1
    for i in range(n // 2):
        out[i] = _to_words(cur * R % p, limbs)
        cur = cur * w % p
    return out


@functools.lru_cache(maxsize=64)
def device_table(builder, args: tuple, device: str) -> torch.Tensor:
    """A host table builder(*args) as a tensor on `device`, made once."""
    return torch.as_tensor(builder(*args), device=device)


def big_ntt(F: BigMontField, x: torch.Tensor, w: int) -> torch.Tensor:
    """Forward NTT: x (..., n, limbs) Montgomery words -> the same shape,
    natural order in and out; iterative DIT over the element axis -2."""
    n = x.shape[-2]
    if n & (n - 1):
        raise ValueError("NTT size must be a power of two")
    if n == 1:
        return x
    if pow(w, n, F.p) != 1 or pow(w, n // 2, F.p) == 1:
        raise ValueError(f"{w} is not a primitive order-{n} root mod {F.p}")
    dev = str(x.device)
    tw_all = device_table(_twiddle_words, (F.p, w, n, F.limbs), dev)
    y = x[..., device_table(_bitrev, (n,), dev), :]
    half = 1
    while half < n:
        stride = n // (2 * half)
        tw = tw_all[::stride][:half]
        yv = y.reshape(y.shape[:-2] + (n // (2 * half), 2, half, F.limbs))
        even = yv[..., 0, :, :]
        odd = F.mont_mul(yv[..., 1, :, :], tw)
        y = torch.cat([F.add(even, odd), F.sub(even, odd)], dim=-2
                      ).reshape(y.shape[:-2] + (n, F.limbs))
        half *= 2
    return y


def big_intt(F: BigMontField, x: torch.Tensor, w: int) -> torch.Tensor:
    n = x.shape[-2]
    y = big_ntt(F, x, pow(w, -1, F.p))
    return F.mont_mul(y, F.const(pow(n, -1, F.p)))
