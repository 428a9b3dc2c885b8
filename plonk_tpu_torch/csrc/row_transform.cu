// K5: one complete size-C transform per row.
//
// Replaces: plonk_tpu/ops/pallas_ntt.py::_full_row_kernel (called through
// row_transform from plonk_tpu/ops/fused_ntt.py::_row_pass, the two row
// passes of the five-step fused_ntt / fused_intt).
//
// Computes, for each C-wide row of a (R, C) array of Montgomery words, all
// log2(C) radix-2 stages, exactly as the TPU kernel does:
// - DIF (natural -> bit-reversed): stages half = C/2 .. 1, the pair
//   (a, b) = (y[lo], y[lo+half]) becomes (a + b, (a - b) * tw[s][lo+half]);
// - DIT (bit-reversed -> natural): stages half = 1 .. C/2, the pair becomes
//   (a + b * tw[s][lo], a - b * tw[s][lo+half]).
// The twiddle is read by lane, like the TPU kernel's lane vector, from the
// (log2 C, C) tables of ops/ntt._stage_tables.
//
// Bound on the H100: device memory. Each row is read once and written once
// (4 bytes of value per 31-bit word; the port's int64 I/O moves 8); the
// log2(C)/2 Montgomery products per word in between stay below the card's
// integer rate.
// Design: K1's (csrc/row_stages.cu): one block per row, C/2 threads, the
// row kept in shared memory (2 KB at C = 512) for all stages, one butterfly
// per thread per stage, one barrier per stage. The stage tables are shared
// by all rows and stay in L2. Any power-of-two C from 2 to 1024.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

__global__ void row_transform_kernel(const long long* __restrict__ y,
                                     const long long* __restrict__ tw,
                                     long long* __restrict__ out, int C,
                                     int S, int dif, MontParams f) {
  extern __shared__ uint32_t row[];
  const size_t base = (size_t)blockIdx.x * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    row[j] = (uint32_t)y[base + j];
  __syncthreads();

  const int t = threadIdx.x;  // butterfly index in [0, C/2)
  for (int k = 0; k < S; ++k) {
    const int s = dif ? S - 1 - k : k;
    const int half = 1 << s;
    const int lo = ((t >> s) << (s + 1)) | (t & (half - 1));
    const int hi = lo + half;
    const uint32_t a = row[lo];
    const uint32_t b = row[hi];
    const uint32_t tw_hi = (uint32_t)tw[(size_t)s * C + hi];
    if (dif) {
      row[lo] = mont_add(a, b, f.p);
      row[hi] = mont_mul(mont_sub(a, b, f.p), tw_hi, f);
    } else {
      const uint32_t tw_lo = (uint32_t)tw[(size_t)s * C + lo];
      row[lo] = mont_add(a, mont_mul(b, tw_lo, f), f.p);
      row[hi] = mont_sub(a, mont_mul(b, tw_hi, f), f.p);
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < C; j += blockDim.x)
    out[base + j] = (long long)row[j];
}

// y, out: (R, C) int64; tw: (S, C) int64 with S = log2(C), 2 <= C <= 1024.
extern "C" int row_transform_launch(const void* y, const void* tw, void* out,
                                    int R, int C, int S, int dif, unsigned p,
                                    unsigned n_prime, void* stream) {
  MontParams f{p, n_prime};
  row_transform_kernel<<<R, C / 2, C * sizeof(uint32_t),
                         (cudaStream_t)stream>>>(
      (const long long*)y, (const long long*)tw, (long long*)out, C, S, dif,
      f);
  return (int)cudaGetLastError();
}
