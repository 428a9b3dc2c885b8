// K3: all butterfly stages of size-C transforms over BN254-Fr, one row each.
//
// Replaces: plonk_tpu/ops/pallas_bigntt.py::_row_kernel (called through
// _big_row_pass from big_fused_ntt / big_fused_intt, the BN254 prover's
// 4n-coset transforms).
//
// Computes, for each row of a (R, C, 16) array of Montgomery words (16-bit
// words in int64, elements along C), all log2(C) radix-2 stages: DIF
// (forward; stages from half = C/2 down to 1) or DIT (inverse; half = 1 up
// to C/2), then an optional product by a scale (the inverse's 1/n). With
// the pair (lo, hi = lo + half) of stage s and the twiddle
// w = w_row^((lo mod half) * C / (2 half)):
//   DIF: lo <- lo + hi,        hi <- (lo - hi) * w
//   DIT: lo <- lo + hi * w,    hi <- lo - hi * w
// the TPU kernel's lane-roll butterflies. Output words are canonical, as
// the TPU kernel's final csub_p makes them.
//
// Bound on the H100: integer multiply throughput at the prover's shapes.
// A row's C/2 * log2(C) Montgomery products are 264 32-bit multiply-adds
// each (128 32x32->64 products of two each, and the 8 m_i): 924 per
// element at C = 128, against 64 bytes of value per element read and
// written (32 each way), which device memory moves in less time. The port
// stores the 16-bit words in int64, so the kernel moves 4x those bytes: at
// (1280, 128) that int64 floor (0.0125 ms) lies above the operations bound
// (0.0091 ms).
//
// Design. A block of 128 threads takes 256 elements: 2 rows at C = 128
// (256 / C rows; a row of 512 or 1024 gives each thread 2 or 4 butterflies
// a stage). Its rows are contiguous in device memory, so the block reads
// them with 16-byte loads, neighbouring threads on neighbouring words,
// each load one pair of 16-bit words, that is one 32-bit limb, into shared
// memory (32 bytes an element); the C/2 distinct twiddles (w_row^e, packed
// once by the wrapper as eight 32-bit limbs) go to shared memory beside
// them. Each stage gives a thread one butterfly of its block's rows, with
// a barrier between stages. Values stay lazy (< 2p, bigmont.cuh's _lazy
// functions, as the TPU kernel keeps them) and become canonical once,
// after the last stage and the scale; stage half = 1 has twiddle 1 and no
// product. The rows leave as they came, through shared memory with
// 16-byte stores. A 256-bit product is one long carry chain, and the card
// hides its latency only with more threads in flight: register rounds of
// radix 4 (4 elements a thread, 4 barriers instead of 7 at C = 128) were
// slower at every shape of the prover, their two products a stage not
// overlapping even when interleaved round by round (PERF.md, §6).
#include <cuda_runtime.h>
#include <cstdint>

#include "bigmont.cuh"

constexpr int kThreads = 128;

__device__ __forceinline__ void load_el(uint32_t r[BIG_LIMBS],
                                        const uint32_t* s) {
  const uint4 a = reinterpret_cast<const uint4*>(s)[0];
  const uint4 b = reinterpret_cast<const uint4*>(s)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void store_el(uint32_t* s,
                                         const uint32_t r[BIG_LIMBS]) {
  reinterpret_cast<uint4*>(s)[0] = make_uint4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<uint4*>(s)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// x with a zero bit inserted at position p.
__device__ __forceinline__ uint32_t insert0(uint32_t x, int p) {
  return ((x >> p) << (p + 1)) | (x & ((1u << p) - 1));
}

__global__ void __launch_bounds__(kThreads)
    big_row_kernel(const long long* __restrict__ y,
                   const uint32_t* __restrict__ pw,
                   long long* __restrict__ out, int R, int C, int S,
                   int rb, int dif, BigField f, U256 scale, int scaled) {
  extern __shared__ uint4 smem[];
  const int W = C << rb;  // elements of the tile: 2^rb rows
  uint32_t* el = reinterpret_cast<uint32_t*>(smem);  // W x 8 limbs
  uint32_t* tws = el + W * BIG_LIMBS;                // C/2 x 8 limbs
  const long long row0 = (long long)blockIdx.x << rb;
  const long long left = R - row0;
  const int valid = (int)(left < (1ll << rb) ? left : 1ll << rb) * C;
  const longlong2* src =
      reinterpret_cast<const longlong2*>(y + row0 * C * 16);
  for (int L = threadIdx.x; L < W * BIG_LIMBS; L += blockDim.x) {
    uint32_t v = 0;
    if ((L >> 3) < valid) {
      const longlong2 x = src[L];
      v = (uint32_t)x.x | ((uint32_t)x.y << 16);
    }
    el[L] = v;
  }
  for (int L = threadIdx.x; L < (C / 2) * BIG_LIMBS; L += blockDim.x)
    tws[L] = pw[L];
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const int s = dif ? S - 1 - k : k;
    for (uint32_t t = threadIdx.x; t < (uint32_t)(W / 2); t += blockDim.x) {
      const uint32_t lo = insert0(t, s), hi = lo | 1u << s;
      uint32_t a[BIG_LIMBS], b[BIG_LIMBS], u[BIG_LIMBS];
      load_el(a, el + lo * BIG_LIMBS);
      load_el(b, el + hi * BIG_LIMBS);
      if (s == 0) {  // half = 1: the twiddle is 1
        big_copy(u, b);
      } else {
        uint32_t w[BIG_LIMBS];
        load_el(w, tws + ((lo & ((1u << s) - 1)) << (S - 1 - s)) * BIG_LIMBS);
        if (dif) {
          big_sub_lazy(u, a, b, f);
          big_add_lazy(a, a, b, f);
          big_mul_lazy(b, u, w, f);
        } else {
          big_mul_lazy(u, b, w, f);
        }
      }
      if (s == 0 || !dif) {
        big_sub_lazy(b, a, u, f);
        big_add_lazy(a, a, u, f);
      }
      if (k == S - 1) {  // the last stage: scale, then canonical words
        if (scaled) {
          big_mul_lazy(a, a, scale.v, f);
          big_mul_lazy(b, b, scale.v, f);
        }
        big_csub(a, a, f);
        big_csub(b, b, f);
      }
      store_el(el + lo * BIG_LIMBS, a);
      store_el(el + hi * BIG_LIMBS, b);
    }
    __syncthreads();
  }

  longlong2* dst = reinterpret_cast<longlong2*>(out + row0 * C * 16);
  for (int L = threadIdx.x; L < W * BIG_LIMBS; L += blockDim.x)
    if ((L >> 3) < valid)
      dst[L] = make_longlong2((long long)(el[L] & 0xFFFFu),
                              (long long)(el[L] >> 16));
}

// y, out: (R, C, 16) int64 words, 16-byte aligned; pw: (C/2, 8) uint32
// limbs of w_row^e in Montgomery form; S = log2(C), 2 <= C <= 1024.
extern "C" int big_row_launch(const void* y, const void* pw, void* out, int R,
                              int C, int S, int dif, BigField f, U256 scale,
                              int scaled, void* stream) {
  int rb = 0;  // log2 of the rows of a block: 2 elements a thread
  while ((C << (rb + 1)) <= 2 * kThreads && (1 << rb) < R) ++rb;
  const int blocks = (R + (1 << rb) - 1) >> rb;
  const size_t smem =
      ((size_t)(C << rb) + C / 2) * BIG_LIMBS * sizeof(uint32_t);
  big_row_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)y, (const uint32_t*)pw, (long long*)out, R, C, S, rb,
      dif, f, scale, scaled);
  return (int)cudaGetLastError();
}
