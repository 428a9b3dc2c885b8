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
// the pair (lo, hi = lo + half) of stage s and the twiddle w = tw[s][hi]:
//   DIF: lo <- lo + hi,        hi <- (lo - hi) * w
//   DIT: lo <- lo + hi * w,    hi <- lo - hi * w
// the TPU kernel's lane-roll butterflies (the per-stage tables of
// _row_tables hold the same value on both lanes of a pair). Output words
// are canonical, as the TPU kernel's final csub_p makes them.
//
// Bound on the H100: integer multiply throughput at the prover's shapes.
// A row's C/2 * log2(C) Montgomery products are 264 32-bit multiply-adds
// each (128 32x32->64 products of two each, and the 8 m_i): 924 per
// element at C = 128, against 64 bytes of value per element read and
// written (32 each way), which device memory moves in less time. The port
// stores the 16-bit words in int64, so the kernel moves 4x those bytes.
// The products are bigmont.cuh's PTX carry chains, made canonical by
// big_mul's final subtraction.
// Design: one block per row, C/2 threads, the row packed to eight 32-bit
// limbs per element in shared memory (4 KB at C = 128) for all stages, one
// butterfly per thread per stage with a barrier between stages. The TPU
// kernel reached partners by lane rolls and carried lazy (< 2p) residues;
// here a thread addresses its pair in shared memory and every operation
// is fully reduced. The twiddle table (S, C, 16) is shared by all rows and
// stays in L2.
#include <cuda_runtime.h>
#include <cstdint>

#include "bigmont.cuh"

__global__ void big_row_kernel(const long long* __restrict__ y,
                               const long long* __restrict__ tw,
                               long long* __restrict__ out, int C, int S,
                               int dif, BigField f, U256 scale,
                               int scaled) {
  extern __shared__ uint32_t row[];  // C * BIG_LIMBS
  const size_t base = (size_t)blockIdx.x * C * 16;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    big_load(y + base + (size_t)j * 16, row + j * BIG_LIMBS);
  __syncthreads();

  const int t = threadIdx.x;  // butterfly index in [0, C/2)
  for (int k = 0; k < S; ++k) {
    const int s = dif ? S - 1 - k : k;
    const int half = 1 << s;
    const int lo = ((t >> s) << (s + 1)) | (t & (half - 1));
    const int hi = lo + half;
    uint32_t a[BIG_LIMBS], b[BIG_LIMBS], w[BIG_LIMBS], u[BIG_LIMBS];
    big_copy(a, row + lo * BIG_LIMBS);
    big_copy(b, row + hi * BIG_LIMBS);
    big_load(tw + ((size_t)s * C + hi) * 16, w);
    if (dif) {
      big_sub(u, a, b, f);
      big_add(a, a, b, f);
      big_mul(b, u, w, f);
    } else {
      big_mul(u, b, w, f);
      big_sub(b, a, u, f);
      big_add(a, a, u, f);
    }
    big_copy(row + lo * BIG_LIMBS, a);
    big_copy(row + hi * BIG_LIMBS, b);
    __syncthreads();
  }

  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    uint32_t* e = row + j * BIG_LIMBS;
    if (scaled) big_mul(e, e, scale.v, f);
    big_store(out + base + (size_t)j * 16, e);
  }
}

// y, out: (R, C, 16) int64 words; tw: (S, C, 16) with S = log2(C),
// 2 <= C <= 1024.
extern "C" int big_row_launch(const void* y, const void* tw, void* out, int R,
                              int C, int S, int dif, BigField f, U256 scale,
                              int scaled, void* stream) {
  big_row_kernel<<<R, C / 2, C * BIG_LIMBS * sizeof(uint32_t),
                   (cudaStream_t)stream>>>(
      (const long long*)y, (const long long*)tw, (long long*)out, C, S, dif,
      f, scale, scaled);
  return (int)cudaGetLastError();
}
