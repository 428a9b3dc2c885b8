"""Prime-field arithmetic on int64 tensors.

Port of `plonk_tpu/ops/field.py`, both strategies:
- `Field`, direct reduction for the toy fields (p <= 65535): a*b is
  reduced with one remainder;
- `MontField`, Montgomery form (R = 2^32, odd p < 2^31);
and `make_field`, which picks one for a modulus. Words are the same
integers as the JAX package's uint32 words, held in int64 so that the
CPU backend can add, shift and compare them. Where JAX's uint32
arithmetic wraps at 2^32 (a sub or neg below zero, a product of words
out of range), `Field` masks to 32 bits and gives the same word.

Both offer one interface: `const` returns a Python int, `array`, `zeros`
and `ones` take the device, and add/sub/neg/mul/square/pow_static/pow/
inv/div act elementwise with broadcasting. A direct `Field` holds words
in standard form, so code that only calls that interface (the NTT, the
curve and the pairing) runs over F_17 and F_101 unchanged.

The product a*b of two words is < 2^62 and fits int64. The reduction
follows `plonk_tpu/ops/field.py:255-264` rather than forming
(a*b + m*p) >> 32, which would reach 2^63 + 2^62 and overflow:

    t = (a*b >> 32) + (m*p >> 32) + (lo != 0),   lo = a*b mod 2^32

with m = lo * n' mod 2^32 built from the 16-bit halves of n', so no
product ever wraps. t < 2p, and one conditional subtraction makes it
canonical.

Reference behaviours kept: inv(0) = 0, div(a, 0) = 0, pow(_, 0) = 1
(0^0 included); `Field.const` of a negative int and `Field.from_signed`
reduce as the reference's hf_new / gf_new (C's `%`, then `+ p`).
Constants (`const`, `n_prime`, ...) are Python ints, which broadcast
against a tensor on any device; constructors that make tensors take the
device explicitly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.params import FieldParams

I64 = torch.int64
_M32 = 0xFFFFFFFF


def add_mod(a, b, p: int):
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a, b, p: int):
    d = a - b
    return torch.where(d < 0, d + p, d)


def _pow_bits(F, a, e, nbits: int):
    """a^e for tensor exponents: `nbits` rounds of masked
    square-and-multiply, LSB first."""
    e = torch.as_tensor(e, dtype=I64, device=a.device)
    shape = torch.broadcast_shapes(a.shape, e.shape)
    r = F.ones(shape, a.device)
    base = a.expand(shape)
    e = e.expand(shape)
    for _ in range(nbits):
        r = torch.where((e & 1) == 1, F.mul(r, base), r)
        base = F.square(base)
        e = e >> 1
    return r


def _pow_static(F, a, e: int):
    """a^e for a Python-int exponent by square-and-multiply;
    pow(_, 0) == 1 including 0^0."""
    if e < 0:
        raise ValueError("negative exponent")
    r = F.ones(a.shape, a.device)
    base = a
    while e > 0:
        if e & 1:
            r = F.mul(r, base)
        e >>= 1
        if e:
            base = F.square(base)
    return r


@dataclasses.dataclass(frozen=True)
class Field:
    """Direct-reduction field: p <= 65535, words in standard form."""
    params: FieldParams

    def __post_init__(self):
        if self.p > 0xFFFF:
            raise ValueError(
                f"direct Field requires p <= 65535 (got {self.p}); "
                "use MontField")

    @property
    def p(self) -> int:
        return self.params.p

    # ---- constructors ----
    def const(self, v: int) -> int:
        """A Python int reduced into [0, p), negatives as hf_new does."""
        return v % self.p

    def array(self, xs, device) -> torch.Tensor:
        return torch.as_tensor(np.mod(np.asarray(xs, dtype=np.int64),
                                      self.p), device=device)

    def from_signed(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce signed int32 values into [0, p): C's `v % p`, then `+ p`
        when the remainder is negative (src/hf.h:25-34)."""
        r = torch.fmod(torch.as_tensor(x).to(torch.int32), self.p)
        return torch.where(r < 0, r + self.p, r).to(I64)

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(shape, dtype=I64, device=device)

    def ones(self, shape, device) -> torch.Tensor:
        return torch.ones(shape, dtype=I64, device=device)

    # ---- arithmetic ----
    def add(self, a, b):
        s = (a + b) & _M32
        return torch.where(s >= self.p, s - self.p, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d >= 0, d, (d + self.p) & _M32)

    def neg(self, a):
        return torch.where(a == 0, a, (self.p - a) & _M32)

    def mul(self, a, b):
        return ((a * b) & _M32) % self.p

    def square(self, a):
        return self.mul(a, a)

    # ---- exponentiation ----
    def pow_static(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a Python-int exponent; pow(_, 0) == 1 including 0^0
        (src/hf-test.c:113-118)."""
        return _pow_static(self, a, e)

    def pow(self, a: torch.Tensor, e, nbits: int = 32) -> torch.Tensor:
        """a^e for tensor exponents (elementwise), over `nbits` bits."""
        return _pow_bits(self, a, e, nbits)

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0, as the F17 table and the
        F101 Fermat path of the reference (src/hf.h:145-191,
        src/gf.h:159-162)."""
        return self.pow_static(a, self.p - 2)

    def div(self, a, b):
        """a * inv(b); division by zero yields 0 (src/hf.h:201-203)."""
        return self.mul(a, self.inv(b))

    # ---- host-side helpers (Python ints) ----
    def hconst(self, v: int) -> int:
        return v % self.p

    def hpow(self, a: int, e: int) -> int:
        return pow(a % self.p, e, self.p)

    def hinv(self, a: int) -> int:
        return pow(a % self.p, self.p - 2, self.p)


def mont_mul(a, b, p: int, n_prime: int):
    """REDC(a*b) for words a, b in [0, p): a*b*2^-32 mod p."""
    t = a * b
    lo = t & _M32
    m = (lo * (n_prime & 0xFFFF) + (((lo * (n_prime >> 16)) & 0xFFFF) << 16)
         ) & _M32
    r = (t >> 32) + ((m * p) >> 32) + (lo != 0)
    return torch.where(r >= p, r - p, r)


@dataclasses.dataclass(frozen=True)
class MontField:
    """Montgomery-form field for odd p < 2^31 (R = 2^32).

    add/sub/neg are representation-agnostic; mul multiplies two
    Montgomery-form elements. encode()/decode() convert at the boundary.
    """
    params: FieldParams

    def __post_init__(self):
        p = self.p
        if p % 2 == 0 or p >= (1 << 31):
            raise ValueError("MontField requires odd p < 2^31")

    @property
    def p(self) -> int:
        return self.params.p

    @property
    def n_prime(self) -> int:
        # -p^{-1} mod 2^32
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    @property
    def r_mod_p(self) -> int:
        return (1 << 32) % self.p

    @property
    def r2_mod_p(self) -> int:
        return (1 << 64) % self.p

    # ---- representation ----
    def encode(self, a: torch.Tensor) -> torch.Tensor:
        """standard -> Montgomery form (a * R mod p)."""
        return self.mont_mul(a, self.r2_mod_p)

    def decode(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery -> standard form (a * R^{-1} mod p)."""
        return self.mont_mul(a, 1)

    def const(self, v: int) -> int:
        """Montgomery-form constant, as a Python int."""
        return (v % self.p) * self.r_mod_p % self.p

    def encode_host(self, xs) -> np.ndarray:
        """Host-side Montgomery encoding of integers (any sign) to int64."""
        std = np.mod(np.asarray(xs, dtype=np.int64), self.p)
        return std * self.r_mod_p % self.p

    def array(self, xs, device) -> torch.Tensor:
        return torch.as_tensor(self.encode_host(xs), device=device)

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(shape, dtype=I64, device=device)

    def ones(self, shape, device) -> torch.Tensor:
        # Montgomery form of 1 is R mod p
        return torch.full(shape, self.r_mod_p, dtype=I64, device=device)

    # ---- arithmetic (Montgomery form in, Montgomery form out) ----
    def add(self, a, b):
        return add_mod(a, b, self.p)

    def sub(self, a, b):
        return sub_mod(a, b, self.p)

    def neg(self, a):
        return torch.where(a == 0, a, self.p - a)

    def mont_mul(self, a, b):
        return mont_mul(a, b, self.p, self.n_prime)

    mul = mont_mul

    def square(self, a):
        return self.mont_mul(a, a)

    def pow_static(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a Python-int exponent by square-and-multiply;
        pow(_, 0) == 1 including 0^0."""
        return _pow_static(self, a, e)

    def pow(self, a: torch.Tensor, e, nbits: int = 32) -> torch.Tensor:
        """a^e for tensor exponents (standard-form integers, elementwise),
        over `nbits` bits; `a` and the result in Montgomery form."""
        return _pow_bits(self, a, e, nbits)

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow_static(a, self.p - 2)

    def div(self, a, b):
        """a * inv(b); division by zero yields 0."""
        return self.mul(a, self.inv(b))


def make_field(params: FieldParams):
    """The strategy for a modulus: direct for the toy fields, Montgomery
    otherwise."""
    if params.p <= 0xFFFF:
        return Field(params)
    return MontField(params)
