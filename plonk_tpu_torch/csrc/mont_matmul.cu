// K7: the modular matrix product of the matmul NTT.
//
// Replaces: plonk_tpu/ops/pallas_mxu_ntt.py::_mont_matmul_kernel (called
// through mont_matmul_pallas from mxu_ntt_pallas / mxu_intt_pallas).
//
// Computes out = REDC64(X @ W~) for X (R, C) Montgomery words and
// W~[c, k] = w^{ck} * 2^64 mod p (C, K), given as the TPU kernel's 7-bit
// limb planes (L, C, K) int8: out = (X @ W) * R mod p in Montgomery form,
// canonical. With a twiddle tw (T, K), R a multiple of T, row r of the
// result is then Montgomery-multiplied by tw[r mod T] (the TPU kernel's
// fused twiddle, without materialising the tiled table).
//
// Route: the first of the two exact ones. The TPU kernel splits both
// operands into s8 limbs for its int8 matrix unit (L^2 = 25 limb products,
// int32 buckets, shift-add recomposition). Here the limb planes are
// recomposed into 32-bit words as they are loaded, and each thread forms
// the native 32x32->64 products and sums them into a 128-bit accumulator
// (a 64-bit low word with a carry count): exact for any C. The sum
// V < C * p^2 < 2^72 at C = 512 is reduced by two 32-bit REDC steps,
// V * 2^-64 mod p < p + C/4, and one conditional subtraction, so the words
// equal the TPU kernel's.
// Design: a shared-memory tiled product, 64 x 64 outputs per block of 256
// threads (4 x 4 per thread, rows ty + 16i and columns tx + 16j, so a warp
// reads shared memory without bank conflicts and stores 16 consecutive
// words), the contraction in chunks of 16.
// Bound on the H100: operations. 2^29.3 products per 2560 x 512 x 512
// call; as 32-bit multiply-adds (2 per 64-bit product) at the card's
// integer rate that is ~0.08 ms; as the TPU kernel's 25 int8 limb products
// on the int8 tensor cores (1979 TOP/s) ~0.017 ms, the route a later
// version should take (mma.sync / wgmma s8.s8.s32 with int32 buckets).
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

constexpr int BM = 64;  // rows of a block tile
constexpr int BN = 64;  // columns of a block tile
constexpr int BK = 16;  // contraction chunk
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread

__global__ void __launch_bounds__(256)
    mont_matmul_kernel(const long long* __restrict__ x,
                       const int8_t* __restrict__ wl,
                       const long long* __restrict__ tw,
                       long long* __restrict__ out, int R, int C, int K,
                       int L, int lb, int T, MontParams f) {
  __shared__ uint32_t xs[BK][BM + 1];  // padded: the loads store by c
  __shared__ uint32_t ws[BK][BN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  uint64_t lo[TM][TN];
  uint32_t hi[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      lo[i][j] = 0;
      hi[i][j] = 0;
    }

  for (int c0 = 0; c0 < C; c0 += BK) {
    for (int q = threadIdx.x; q < BM * BK; q += blockDim.x) {
      const int r = q / BK;
      const int c = q % BK;
      const int gr = row0 + r;
      const int gc = c0 + c;
      xs[c][r] = (gr < R && gc < C) ? (uint32_t)x[(size_t)gr * C + gc] : 0u;
    }
    for (int q = threadIdx.x; q < BK * BN; q += blockDim.x) {
      const int c = q / BN;
      const int k = q % BN;
      const int gc = c0 + c;
      const int gk = col0 + k;
      uint32_t v = 0;
      if (gc < C && gk < K)
        for (int a = 0; a < L; ++a)
          v |= (uint32_t)(uint8_t)wl[((size_t)a * C + gc) * K + gk]
               << (lb * a);
      ws[c][k] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      uint32_t xr[TM], wc[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wc[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const uint64_t prod = (uint64_t)xr[i] * wc[j];
          lo[i][j] += prod;
          hi[i][j] += lo[i][j] < prod;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gk = col0 + tx + 16 * j;
      if (gk >= K) continue;
      // V = hi * 2^64 + lo. First REDC: u = (V + m p) / 2^32 < 2^41.
      const uint64_t v_lo = lo[i][j];
      const uint32_t m = (uint32_t)v_lo * f.n_prime;
      const uint64_t s = v_lo + (uint64_t)m * f.p;
      const uint64_t carry = s < v_lo;
      const uint64_t u = ((uint64_t)hi[i][j] + carry) << 32 | (s >> 32);
      // second REDC: r = (u + m2 p) / 2^32 < p + 2^9
      const uint32_t m2 = (uint32_t)u * f.n_prime;
      uint32_t r = (uint32_t)((u + (uint64_t)m2 * f.p) >> 32);
      r = r >= f.p ? r - f.p : r;
      if (T > 0) r = mont_mul(r, (uint32_t)tw[(size_t)(gr % T) * K + gk], f);
      out[(size_t)gr * K + gk] = (long long)r;
    }
  }
}

// x: (R, C) int64; wl: (L, C, K) int8 limb planes of lb bits; tw: (T, K)
// int64 or null with T = 0; out: (R, K) int64.
extern "C" int mont_matmul_launch(const void* x, const void* wl,
                                  const void* tw, void* out, int R, int C,
                                  int K, int L, int lb, int T, unsigned p,
                                  unsigned n_prime, void* stream) {
  MontParams f{p, n_prime};
  dim3 grid((K + BN - 1) / BN, (R + BM - 1) / BM);
  mont_matmul_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (const int8_t*)wl, (const long long*)tw,
      (long long*)out, R, C, K, L, lb, T, f);
  return (int)cudaGetLastError();
}
