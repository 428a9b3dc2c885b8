// 256-bit Montgomery arithmetic for the BN254 fields (Fr and Fq), shared by
// the 16-limb kernels big_row.cu (K3) and big_commit.cu (K4).
//
// The port stores a field element as 16 little-endian 16-bit words, one per
// int64 (plonk_tpu_torch/ops/bigfield.py). A kernel packs them into eight
// 32-bit limbs when it loads an element and unpacks them when it stores
// one. Products use the native 32x32->64 multiply in CIOS form: every step
// a[j]*b[i] + t[j] + carry is at most (2^32-1)^2 + 2(2^32-1) = 2^64-1, so it
// fits an unsigned 64-bit word. With p < 2^254 and inputs < p the CIOS
// result is < 2p; one conditional subtraction makes every output
// canonical, so results equal the port's plain words exactly (R = 2^256 in
// both: eight 32-bit limbs or sixteen 16-bit words).
#pragma once
#include <cstdint>

#define BIG_LIMBS 8

struct BigField {
  uint32_t p[BIG_LIMBS];  // the modulus
  uint32_t np;            // -p^-1 mod 2^32
};

struct U256 {
  uint32_t v[BIG_LIMBS];
};

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

__device__ __forceinline__ bool big_is_zero(const uint32_t a[BIG_LIMBS]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) acc |= a[k];
  return acc == 0;
}

// r = s - p if s >= p, else s (s < 2p). r may alias s.
__device__ __forceinline__ void big_csub(uint32_t r[BIG_LIMBS],
                                         const uint32_t s[BIG_LIMBS],
                                         const BigField& f) {
  uint32_t d[BIG_LIMBS];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    uint64_t t = (uint64_t)s[k] - f.p[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) r[k] = borrow ? s[k] : d[k];
}

// r = a + b mod p for a, b < p (p < 2^254, so a + b has no carry out).
__device__ __forceinline__ void big_add(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  uint32_t s[BIG_LIMBS];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    c += (uint64_t)a[k] + b[k];
    s[k] = (uint32_t)c;
    c >>= 32;
  }
  big_csub(r, s, f);
}

// r = a - b mod p for a, b < p.
__device__ __forceinline__ void big_sub(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  uint32_t d[BIG_LIMBS];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = t >> 63;
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) {
    c += (uint64_t)d[k] + (borrow ? f.p[k] : 0u);
    r[k] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a * b * 2^-256 mod p (CIOS), canonical. r may alias a or b.
__device__ __forceinline__ void big_mul(uint32_t r[BIG_LIMBS],
                                        const uint32_t a[BIG_LIMBS],
                                        const uint32_t b[BIG_LIMBS],
                                        const BigField& f) {
  uint32_t t[BIG_LIMBS + 2];
#pragma unroll
  for (int k = 0; k < BIG_LIMBS + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < BIG_LIMBS; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < BIG_LIMBS; ++j) {
      uint64_t uv = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t uv = (uint64_t)t[BIG_LIMBS] + c;
    t[BIG_LIMBS] = (uint32_t)uv;
    t[BIG_LIMBS + 1] = (uint32_t)(uv >> 32);
    const uint32_t m = t[0] * f.np;
    uv = (uint64_t)m * f.p[0] + t[0];
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < BIG_LIMBS; ++j) {
      uv = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[BIG_LIMBS] + c;
    t[BIG_LIMBS - 1] = (uint32_t)uv;
    t[BIG_LIMBS] = t[BIG_LIMBS + 1] + (uint32_t)(uv >> 32);
  }
  // t < 2p < 2^255: t[BIG_LIMBS] is 0 here
  big_csub(r, t, f);
}
