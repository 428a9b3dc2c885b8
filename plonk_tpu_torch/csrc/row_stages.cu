// K1: the intra-row stages of the blocked NTT.
//
// Replaces: plonk_tpu/ops/pallas_ntt.py::_row_stages_kernel (called through
// row_stages from plonk_tpu/ops/ntt.py:153-160).
//
// Computes, for each C-wide row of a (R, C) array of Montgomery words, all
// log2(C) radix-2 DIT stages with butterfly distance half < C, exactly as
// the TPU kernel does: at stage s (half = 2^s) the low lane j of a pair
// becomes y[j] + y[j+half] * tw[s][j] and the high lane j+half becomes
// y[j] - y[j+half] * tw[s][j+half]. The twiddle is read by lane, like the
// TPU kernel's lane vector, so any (log2 C, C) table gives the same words.
//
// Bound on the H100: device memory. Each row is read once and written once
// (8 bytes of value per 31-bit word; the port's int64 I/O moves 16); the
// log2(C) stages in between cost log2(C)/2 Montgomery products per word,
// below the card's integer rate, plus one block barrier per stage.
// Design: one block per row, C/2 threads, the row kept in shared memory
// (4 KB at C = 1024) for all stages, one butterfly per thread per stage.
// The twiddle table (40 KB at C = 1024) is shared by all rows and stays in
// L2. The TPU kernel reached partners with lane rolls; here a thread
// addresses its pair in shared memory directly.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

__global__ void row_stages_kernel(const long long* __restrict__ y,
                                  const long long* __restrict__ tw,
                                  long long* __restrict__ out, int C, int S,
                                  MontParams f) {
  extern __shared__ uint32_t row[];
  const size_t base = (size_t)blockIdx.x * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    row[j] = (uint32_t)y[base + j];
  __syncthreads();

  const int t = threadIdx.x;  // butterfly index in [0, C/2)
  for (int s = 0; s < S; ++s) {
    const int half = 1 << s;
    const int lo = ((t >> s) << (s + 1)) | (t & (half - 1));
    const int hi = lo + half;
    const uint32_t a = row[lo];
    const uint32_t b = row[hi];
    const uint32_t tw_lo = (uint32_t)tw[(size_t)s * C + lo];
    const uint32_t tw_hi = (uint32_t)tw[(size_t)s * C + hi];
    row[lo] = mont_add(a, mont_mul(b, tw_lo, f), f.p);
    row[hi] = mont_sub(a, mont_mul(b, tw_hi, f), f.p);
    __syncthreads();
  }

  for (int j = threadIdx.x; j < C; j += blockDim.x)
    out[base + j] = (long long)row[j];
}

// y, out: (R, C) int64; tw: (S, C) int64 with S = log2(C), 2 <= C <= 1024.
extern "C" int row_stages_launch(const void* y, const void* tw, void* out,
                                 int R, int C, int S, unsigned p,
                                 unsigned n_prime, void* stream) {
  MontParams f{p, n_prime};
  row_stages_kernel<<<R, C / 2, C * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(
      (const long long*)y, (const long long*)tw, (long long*)out, C, S, f);
  return (int)cudaGetLastError();
}
