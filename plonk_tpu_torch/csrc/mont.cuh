// Montgomery arithmetic (R = 2^32) for odd p < 2^31 on one 32-bit word.
//
// The same words as plonk_tpu_torch/ops/field.py and the JAX package's
// MontField. The TPU kernels split products into 16-bit limbs because the
// TPU vector unit has no 32x32->64 multiply; here the native 64-bit
// product is used: t = a*b < 2^62, m*p < 2^63, so t + m*p < 2^64 fits an
// unsigned 64-bit word, and (t + m*p) >> 32 < 2p.
#pragma once
#include <cstdint>

struct MontParams {
  uint32_t p;
  uint32_t n_prime;  // -p^-1 mod 2^32
};

__device__ __forceinline__ uint32_t mont_add(uint32_t a, uint32_t b,
                                             uint32_t p) {
  uint32_t s = a + b;  // < 2^32 because a, b < p < 2^31
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t mont_sub(uint32_t a, uint32_t b,
                                             uint32_t p) {
  return a >= b ? a - b : a - b + p;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             MontParams f) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * f.n_prime;
  uint32_t r = (uint32_t)((t + (uint64_t)m * f.p) >> 32);
  return r >= f.p ? r - f.p : r;
}
