// 256-bit Montgomery arithmetic for the BN254 fields (Fr and Fq), shared by
// the 16-limb kernels big_row.cu (K3) and big_commit.cu (K4).
//
// The port stores a field element as 16 little-endian 16-bit words, one per
// int64 (plonk_tpu_torch/ops/bigfield.py); K4's packed table holds the same
// element as eight 32-bit limbs. R = 2^256 in both forms.
//
// Products are written with PTX carry chains (mad.lo.cc / madc.hi.cc /
// addc.cc through inline asm volatile, so the chains keep their order):
// nvcc lowers the same loops written over uint64_t to wide multiplies and
// separate 64-bit adds. big_mul_lazy interleaves the products a * b[i] with
// the reduction by m * p in CIOS order, with two accumulators that hold the
// even and the odd limb products, so that each row of products is one
// carry chain without overlapping lo/hi words. big_sqr_lazy forms the
// square once (28 off-diagonal products doubled, 8 diagonal ones) and
// reduces it by separated operand scanning: 100 wide products against 128.
//
// Lazy residues: with p < 2^254, 4p < 2^256. For inputs below 2p the CIOS
// result (a b + m p) / R is below (4p^2 + R p) / R < 2p, so the _lazy
// functions take and give values in [0, 2p) without a final subtraction;
// big_csub brings such a value to [0, p). A lazy value is zero mod p when
// it is 0 or p (big_is_zero_lazy). big_add / big_sub / big_mul keep K3's
// canonical contract: canonical inputs give canonical outputs.
#pragma once
#include <cstdint>

#define BIG_LIMBS 8

struct BigField {
  uint32_t p[BIG_LIMBS];   // the modulus
  uint32_t p2[BIG_LIMBS];  // 2p
  uint32_t np;             // -p^-1 mod 2^32
};

struct U256 {
  uint32_t v[BIG_LIMBS];
};

// ---- carry-chain primitives (PTX) ----
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// ---- end of carry-chain primitives ----

__device__ __forceinline__ void big_load(const long long* __restrict__ src,
                                         uint32_t out[BIG_LIMBS]) {
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k)
    out[k] = (uint32_t)src[2 * k] | ((uint32_t)src[2 * k + 1] << 16);
}

__device__ __forceinline__ void big_store(long long* __restrict__ dst,
                                          const uint32_t v[BIG_LIMBS]) {
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    dst[2 * k] = (long long)(v[k] & 0xFFFFu);
    dst[2 * k + 1] = (long long)(v[k] >> 16);
  }
}

__device__ __forceinline__ void big_copy(uint32_t r[BIG_LIMBS],
                                         const uint32_t a[BIG_LIMBS]) {
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) r[k] = a[k];
}

// a in [0, 2p) is zero mod p: a == 0 or a == p.
__device__ __forceinline__ bool big_is_zero_lazy(const uint32_t a[BIG_LIMBS],
                                                 const BigField& f) {
  uint32_t z = 0, e = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    z |= a[k];
    e |= a[k] ^ f.p[k];
  }
  return z == 0 || e == 0;
}

// r = s - m if s >= m, else s (m = p or 2p given as limbs). r may alias s.
__device__ __forceinline__ void big_csub_by(uint32_t r[BIG_LIMBS],
                                            const uint32_t s[BIG_LIMBS],
                                            const uint32_t m[BIG_LIMBS]) {
  uint32_t d[BIG_LIMBS];
  d[0] = sub_cc(s[0], m[0]);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS; ++k) d[k] = subc_cc(s[k], m[k]);
  const uint32_t borrow = subc(0u, 0u);  // 0xFFFFFFFF if s < m
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) r[k] = borrow ? s[k] : d[k];
}

// r = s mod p for s in [0, 2p): the canonical word. r may alias s.
__device__ __forceinline__ void big_csub(uint32_t r[BIG_LIMBS],
                                         const uint32_t s[BIG_LIMBS],
                                         const BigField& f) {
  big_csub_by(r, s, f.p);
}

// s = a + b, no carry out (a + b < 2^256).
__device__ __forceinline__ void big_add_raw(uint32_t s[BIG_LIMBS],
                                            const uint32_t a[BIG_LIMBS],
                                            const uint32_t b[BIG_LIMBS]) {
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS - 1; ++k) s[k] = addc_cc(a[k], b[k]);
  s[BIG_LIMBS - 1] = addc(a[BIG_LIMBS - 1], b[BIG_LIMBS - 1]);
}

// r = a - b, plus m if that borrows (m = p or 2p). r may alias a or b.
__device__ __forceinline__ void big_sub_by(uint32_t r[BIG_LIMBS],
                                           const uint32_t a[BIG_LIMBS],
                                           const uint32_t b[BIG_LIMBS],
                                           const uint32_t m[BIG_LIMBS]) {
  uint32_t d[BIG_LIMBS];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS; ++k) d[k] = subc_cc(a[k], b[k]);
  const uint32_t borrow = subc(0u, 0u);
  r[0] = add_cc(d[0], m[0] & borrow);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS - 1; ++k) r[k] = addc_cc(d[k], m[k] & borrow);
  r[BIG_LIMBS - 1] = addc(d[BIG_LIMBS - 1], m[BIG_LIMBS - 1] & borrow);
}

// r = a + b mod p for a, b < p (canonical in and out).
__device__ __forceinline__ void big_add(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  uint32_t s[BIG_LIMBS];
  big_add_raw(s, a, b);
  big_csub_by(r, s, f.p);
}

// r = a - b mod p for a, b < p (canonical in and out).
__device__ __forceinline__ void big_sub(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  big_sub_by(r, a, b, f.p);
}

// r = a + b for a, b in [0, 2p), reduced to [0, 2p) (a + b < 4p < 2^256).
__device__ __forceinline__ void big_add_lazy(uint32_t r[BIG_LIMBS],
                                             const uint32_t a[BIG_LIMBS],
                                             const uint32_t b[BIG_LIMBS],
                                             const BigField& f) {
  uint32_t s[BIG_LIMBS];
  big_add_raw(s, a, b);
  big_csub_by(r, s, f.p2);
}

// r = a - b for a, b in [0, 2p), in [0, 2p).
__device__ __forceinline__ void big_sub_lazy(uint32_t r[BIG_LIMBS],
                                             const uint32_t a[BIG_LIMBS],
                                             const uint32_t b[BIG_LIMBS],
                                             const BigField& f) {
  big_sub_by(r, a, b, f.p2);
}

// acc[j] += a[j] * bi (lo) and acc[j + 1] += hi, for even j < n: a chain
// whose carry-out is left in the flag. a points at an even or odd limb, so
// that a[j] for even j walks the limbs of one parity.
template <int n>
__device__ __forceinline__ void big_cmad(uint32_t* acc, const uint32_t* a,
                                         uint32_t bi) {
  acc[0] = mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < n; j += 2) {
    acc[j] = madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

template <int n>
__device__ __forceinline__ void big_mul_n(uint32_t* acc, const uint32_t* a,
                                          uint32_t bi) {
#pragma unroll
  for (int j = 0; j < n; j += 2) {
    acc[j] = mul_lo(a[j], bi);
    acc[j + 1] = mul_hi(a[j], bi);
  }
}

// odd[j] = lo/hi of a[j] * bi + odd[j + 2] (+ the incoming carry): the
// accumulator shifted down by two limbs while the row is added.
__device__ __forceinline__ void big_madc_rshift(uint32_t* odd,
                                                const uint32_t* a,
                                                uint32_t bi) {
#pragma unroll
  for (int j = 0; j < BIG_LIMBS - 2; j += 2) {
    odd[j] = madc_lo_cc(a[j], bi, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(a[j], bi, odd[j + 3]);
  }
  odd[BIG_LIMBS - 2] = madc_lo_cc(a[BIG_LIMBS - 2], bi, 0u);
  odd[BIG_LIMBS - 1] = madc_hi(a[BIG_LIMBS - 2], bi, 0u);
}

// One CIOS round on the even/odd accumulators: add a * bi, then m * p with
// m = even[0] * np, which zeroes the lowest limb; the division by 2^32 is
// the swap of the two accumulators' roles in the next round.
__device__ __forceinline__ void big_mad_redc(uint32_t* even, uint32_t* odd,
                                             const uint32_t* a, uint32_t bi,
                                             const BigField& f, bool first) {
  if (first) {
    big_mul_n<BIG_LIMBS>(odd, a + 1, bi);
    big_mul_n<BIG_LIMBS>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    big_madc_rshift(odd, a + 1, bi);
    big_cmad<BIG_LIMBS>(even, a, bi);
    odd[BIG_LIMBS - 1] = addc(odd[BIG_LIMBS - 1], 0u);
  }
  const uint32_t mi = even[0] * f.np;
  big_cmad<BIG_LIMBS>(odd, f.p + 1, mi);
  big_cmad<BIG_LIMBS>(even, f.p, mi);
  odd[BIG_LIMBS - 1] = addc(odd[BIG_LIMBS - 1], 0u);
}

// r = a * b * 2^-256 mod p for a, b in [0, 2p), in [0, 2p). r may alias a
// or b.
__device__ __forceinline__ void big_mul_lazy(uint32_t r[BIG_LIMBS],
                                             const uint32_t a[BIG_LIMBS],
                                             const uint32_t b[BIG_LIMBS],
                                             const BigField& f) {
  uint32_t even[BIG_LIMBS], odd[BIG_LIMBS];
  const uint32_t b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3], b4 = b[4],
                 b5 = b[5], b6 = b[6], b7 = b[7];
  uint32_t av[BIG_LIMBS];
  big_copy(av, a);
  big_mad_redc(even, odd, av, b0, f, true);
  big_mad_redc(odd, even, av, b1, f, false);
  big_mad_redc(even, odd, av, b2, f, false);
  big_mad_redc(odd, even, av, b3, f, false);
  big_mad_redc(even, odd, av, b4, f, false);
  big_mad_redc(odd, even, av, b5, f, false);
  big_mad_redc(even, odd, av, b6, f, false);
  big_mad_redc(odd, even, av, b7, f, false);
  // merge: even + odd shifted down by one limb
  r[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS - 1; ++k) r[k] = addc_cc(even[k], odd[k + 1]);
  r[BIG_LIMBS - 1] = addc(even[BIG_LIMBS - 1], 0u);
}

// acc[i + j] += a[i] a[j] (lo, hi) for j = j0, j0 + 2, ... < BIG_LIMBS:
// one carry chain over non-overlapping words, its carry-out added to the
// next word, which so far holds only carries of earlier rows.
__device__ __forceinline__ void big_sqr_row(uint32_t (&acc)[2 * BIG_LIMBS],
                                            const uint32_t a[BIG_LIMBS],
                                            int i, int j0) {
  acc[i + j0] = mad_lo_cc(a[i], a[j0], acc[i + j0]);
  acc[i + j0 + 1] = madc_hi_cc(a[i], a[j0], acc[i + j0 + 1]);
  int top = i + j0 + 2;
#pragma unroll
  for (int j = j0 + 2; j < BIG_LIMBS; j += 2) {
    acc[i + j] = madc_lo_cc(a[i], a[j], acc[i + j]);
    acc[i + j + 1] = madc_hi_cc(a[i], a[j], acc[i + j + 1]);
    top = i + j + 2;
  }
  if (top < 2 * BIG_LIMBS) acc[top] = addc(acc[top], 0u);
}

// r = a^2 * 2^-256 mod p for a in [0, 2p), in [0, 2p). r may alias a.
__device__ __forceinline__ void big_sqr_lazy(uint32_t r[BIG_LIMBS],
                                             const uint32_t a[BIG_LIMBS],
                                             const BigField& f) {
  // off-diagonal sum S = sum_{i<j} a_i a_j 2^(32(i+j)) in two accumulators
  // of 16 words, E (rows of products starting at an even word) and O
  // (odd).
  uint32_t E[2 * BIG_LIMBS], O[2 * BIG_LIMBS];
#pragma unroll
  for (int k = 0; k < 2 * BIG_LIMBS; ++k) {
    E[k] = 0;
    O[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < BIG_LIMBS - 1; ++i) {
    big_sqr_row(O, a, i, i + 1);  // j = i + 1, i + 3, ...: odd words
    if (i + 2 < BIG_LIMBS) big_sqr_row(E, a, i, i + 2);  // even words
  }
  // T2 = 2 (E + O) + sum_i a_i^2 2^(64i) = a^2 (< 4p^2 < 2^510): E + O,
  // then doubled by funnel shifts with the diagonal added.
  uint32_t T[2 * BIG_LIMBS];
  T[0] = add_cc(E[0], O[0]);
#pragma unroll
  for (int k = 1; k < 2 * BIG_LIMBS - 1; ++k) T[k] = addc_cc(E[k], O[k]);
  T[2 * BIG_LIMBS - 1] = addc(E[2 * BIG_LIMBS - 1], O[2 * BIG_LIMBS - 1]);
  uint32_t D[2 * BIG_LIMBS];
#pragma unroll
  for (int i = 0; i < BIG_LIMBS; ++i) {
    D[2 * i] = mul_lo(a[i], a[i]);
    D[2 * i + 1] = mul_hi(a[i], a[i]);
  }
  uint32_t T2[2 * BIG_LIMBS];
  T2[0] = add_cc(T[0] << 1, D[0]);
#pragma unroll
  for (int k = 1; k < 2 * BIG_LIMBS - 1; ++k)
    T2[k] = addc_cc(__funnelshift_l(T[k - 1], T[k], 1), D[k]);
  T2[2 * BIG_LIMBS - 1] = addc(
      __funnelshift_l(T[2 * BIG_LIMBS - 2], T[2 * BIG_LIMBS - 1], 1),
      D[2 * BIG_LIMBS - 1]);
  // Montgomery reduction of the low half (separated operand scanning):
  // eight rounds t = (t + m p) / 2^32 on a nine-word window, which stays
  // below 2^288 (t < R before each addition of m p < 2^32 p), so the
  // result (lo + M p) / R <= p; adding the high half (< 4p^2 / R < p)
  // gives a^2 / R mod p in [0, 2p).
  uint32_t t[BIG_LIMBS + 1];
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) t[k] = T2[k];
  t[BIG_LIMBS] = 0;
#pragma unroll
  for (int i = 0; i < BIG_LIMBS; ++i) {
    const uint32_t m = t[0] * f.np;
    // even limbs of p: words 0..7, carry into word 8
    t[0] = mad_lo_cc(m, f.p[0], t[0]);
    t[1] = madc_hi_cc(m, f.p[0], t[1]);
#pragma unroll
    for (int j = 2; j < BIG_LIMBS; j += 2) {
      t[j] = madc_lo_cc(m, f.p[j], t[j]);
      t[j + 1] = madc_hi_cc(m, f.p[j], t[j + 1]);
    }
    t[BIG_LIMBS] = addc(t[BIG_LIMBS], 0u);
    // odd limbs of p: words 1..8
    t[1] = mad_lo_cc(m, f.p[1], t[1]);
    t[2] = madc_hi_cc(m, f.p[1], t[2]);
#pragma unroll
    for (int j = 3; j < BIG_LIMBS; j += 2) {
      t[j] = madc_lo_cc(m, f.p[j], t[j]);
      t[j + 1] = madc_hi_cc(m, f.p[j], t[j + 1]);
    }
    // t[0] is now 0: shift down one word
#pragma unroll
    for (int k = 0; k < BIG_LIMBS; ++k) t[k] = t[k + 1];
    t[BIG_LIMBS] = 0;
  }
  // r = t + the high half of a^2
  r[0] = add_cc(t[0], T2[BIG_LIMBS]);
#pragma unroll
  for (int k = 1; k < BIG_LIMBS - 1; ++k)
    r[k] = addc_cc(t[k], T2[BIG_LIMBS + k]);
  r[BIG_LIMBS - 1] = addc(t[BIG_LIMBS - 1], T2[2 * BIG_LIMBS - 1]);
}

// r = a * b * 2^-256 mod p, canonical, for a, b < p (K3's product). r may
// alias a or b.
__device__ __forceinline__ void big_mul(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  big_mul_lazy(r, a, b, f);
  big_csub_by(r, r, f.p);
}
