// K6: the whole four-step transform of each batch element in one launch.
//
// Replaces: plonk_tpu/ops/fused_ntt.py::_full2d_kernel (called through
// _onepass from fused_ntt_1k / fused_intt_1k).
//
// Computes, for each (n1, n2) matrix of Montgomery words, what the TPU
// kernel computes in one VMEM residency:
// - forward (mirror = 0): DIF stages along axis 0 (length n1, tables tw1),
//   the elementwise twiddle twm (n1, n2), DIF stages along axis 1 (length
//   n2, tables tw2); natural input, scrambled output;
// - mirror = 1: DIT along axis 1 (tw2), the twiddle, DIT along axis 0
//   (tw1), then the product by `scale` (1/n in Montgomery form) if scaled.
// The butterflies and lane twiddles are K5's (csrc/row_transform.cu).
//
// Design (b) of the two that fit: a cooperative launch with one grid-wide
// barrier over an L2-resident scratch. The TPU kernel keeps the whole
// matrix (1 MB of 31-bit words at 2^18) in VMEM; one H100 block has at most
// 227 KB of shared memory, so no block can hold it. Instead each axis pass
// runs from shared memory on pieces that hold whole transforms: the axis-0
// pass on column tiles (n1 rows by tc columns, 32 KB at n1 = 512), the
// axis-1 pass on whole rows (2 KB at n2 = 512). The twiddle is applied by
// the first pass as it stores, the 1/n scale by the second. The first pass
// writes into the output array, which the second pass then transforms in
// place; between them one grid.sync(), which needs every block resident at
// once, hence cudaLaunchCooperativeKernel with at most as many blocks as
// the card holds, each block walking over its share of tiles and rows. The
// whole output (nb * 2 MB of int64 words) is in flight between the passes;
// at the path's shapes (nb <= 10) it fits the 50 MB L2. This was chosen
// over design (a), a cluster of 8 blocks per matrix reading each other's
// shared memory with a cluster barrier per stage, because it needs one
// barrier per transform instead of eighteen, works unchanged for any
// (n1, n2) down to (1, 2), and keeps K5's butterfly code as it is.
//
// Bound on the H100: device memory. Each word is read once and written once
// (4 bytes of value each; the port's int64 I/O moves 8), and the tables
// once; the (S1 + S2)/2 + 1 Montgomery products per word, 4 32-bit
// multiply-adds each (a * b as a 32x32->64 product of two, m = lo(ab) n'
// and the high half of m p, one each), take a little less time at
// (5, 512, 512). The scratch round trip between the passes stays in L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTileWords = 8192;  // shared words of a column tile (32 KB)

// All stages of the size-len transforms held in sm with element i of
// transform c at sm[i * width + c], for c < width; lane twiddles
// tw[s * len + i].
__device__ void transform_tile(uint32_t* sm, int len, int width, int S,
                               const long long* __restrict__ tw, bool dif,
                               MontParams f) {
  const int pairs = (len / 2) * width;
  for (int k = 0; k < S; ++k) {
    const int s = dif ? S - 1 - k : k;
    const int half = 1 << s;
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int t = q / width;
      const int c = q - t * width;
      const int lo = ((t >> s) << (s + 1)) | (t & (half - 1));
      const int hi = lo + half;
      const uint32_t a = sm[lo * width + c];
      const uint32_t b = sm[hi * width + c];
      const uint32_t tw_hi = (uint32_t)tw[(size_t)s * len + hi];
      if (dif) {
        sm[lo * width + c] = mont_add(a, b, f.p);
        sm[hi * width + c] = mont_mul(mont_sub(a, b, f.p), tw_hi, f);
      } else {
        const uint32_t tw_lo = (uint32_t)tw[(size_t)s * len + lo];
        sm[lo * width + c] = mont_add(a, mont_mul(b, tw_lo, f), f.p);
        sm[hi * width + c] = mont_sub(a, mont_mul(b, tw_hi, f), f.p);
      }
    }
    __syncthreads();
  }
}

// Axis-0 pass over every column tile: src -> dst, both (nb, n1, n2). The
// result is multiplied by twm (n1, n2) if given, then by `scale` if scaled.
__device__ void column_pass(const long long* src, long long* dst, uint32_t* sm,
                            int nb, int n1, int n2, int tc, int S1,
                            const long long* __restrict__ tw1, bool dif,
                            const long long* __restrict__ twm,
                            uint32_t scale, bool scaled, MontParams f) {
  const size_t mat = (size_t)n1 * n2;
  const int per_mat = n2 / tc;
  const int words = n1 * tc;
  for (int w = blockIdx.x; w < nb * per_mat; w += gridDim.x) {
    const size_t col = (size_t)(w % per_mat) * tc;  // first column of tile
    const size_t off = (size_t)(w / per_mat) * mat;
    for (int q = threadIdx.x; q < words; q += blockDim.x) {
      const int i = q / tc;
      sm[q] = (uint32_t)src[off + (size_t)i * n2 + col + (q - i * tc)];
    }
    __syncthreads();
    transform_tile(sm, n1, tc, S1, tw1, dif, f);
    for (int q = threadIdx.x; q < words; q += blockDim.x) {
      const int i = q / tc;
      const size_t at = (size_t)i * n2 + col + (q - i * tc);
      uint32_t v = sm[q];
      if (twm != nullptr) v = mont_mul(v, (uint32_t)twm[at], f);
      if (scaled) v = mont_mul(v, scale, f);
      dst[off + at] = (long long)v;
    }
    __syncthreads();
  }
}

// Axis-1 pass over every row: src -> dst, both (nb * n1, n2). The result
// is multiplied by twm (n1, n2) if given.
__device__ void row_pass(const long long* src, long long* dst, uint32_t* sm,
                         int nb, int n1, int n2, int S2,
                         const long long* __restrict__ tw2, bool dif,
                         const long long* __restrict__ twm, MontParams f) {
  for (int w = blockIdx.x; w < nb * n1; w += gridDim.x) {
    const size_t off = (size_t)w * n2;
    for (int j = threadIdx.x; j < n2; j += blockDim.x)
      sm[j] = (uint32_t)src[off + j];
    __syncthreads();
    transform_tile(sm, n2, 1, S2, tw2, dif, f);
    const size_t tw_off = (size_t)(w % n1) * n2;
    for (int j = threadIdx.x; j < n2; j += blockDim.x) {
      uint32_t v = sm[j];
      if (twm != nullptr) v = mont_mul(v, (uint32_t)twm[tw_off + j], f);
      dst[off + j] = (long long)v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    onepass_kernel(const long long* __restrict__ y,
                   const long long* __restrict__ tw1,
                   const long long* __restrict__ twm,
                   const long long* __restrict__ tw2, long long* out, int nb,
                   int n1, int n2, int S1, int S2, int tc, int mirror,
                   uint32_t scale, int scaled, MontParams f) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  if (!mirror) {
    column_pass(y, out, sm, nb, n1, n2, tc, S1, tw1, true, twm, 0, false, f);
    grid.sync();
    row_pass(out, out, sm, nb, n1, n2, S2, tw2, true, nullptr, f);
  } else {
    row_pass(y, out, sm, nb, n1, n2, S2, tw2, false, twm, f);
    grid.sync();
    column_pass(out, out, sm, nb, n1, n2, tc, S1, tw1, false, nullptr, scale,
                scaled != 0, f);
  }
}

// y, out: (nb, n1, n2) int64; tw1: (S1, n1); twm: (n1, n2); tw2: (S2, n2);
// n1 <= n2 powers of two, n1 >= 1, 2 <= n2 <= kTileWords.
extern "C" int onepass_ntt_launch(const void* y, const void* tw1,
                                  const void* twm, const void* tw2, void* out,
                                  int nb, int n1, int n2, int mirror,
                                  unsigned scale, int scaled, unsigned p,
                                  unsigned n_prime, void* stream) {
  MontParams f{p, n_prime};
  int S1 = 0, S2 = 0;
  while ((1 << S1) < n1) ++S1;
  while ((1 << S2) < n2) ++S2;
  int tc = kTileWords / n1;
  if (tc > 16) tc = 16;
  if (tc > n2) tc = n2;
  if (tc < 1) tc = 1;
  const int words = n1 * tc > n2 ? n1 * tc : n2;
  const size_t smem = (size_t)words * sizeof(uint32_t);

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onepass_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int work_cols = nb * (n2 / tc);
  const int work_rows = nb * n1;
  int blocks = work_cols > work_rows ? work_cols : work_rows;
  if (blocks > per_sm * sms) blocks = per_sm * sms;

  const long long* y_ = (const long long*)y;
  const long long* tw1_ = (const long long*)tw1;
  const long long* twm_ = (const long long*)twm;
  const long long* tw2_ = (const long long*)tw2;
  long long* out_ = (long long*)out;
  void* args[] = {&y_, &tw1_, &twm_, &tw2_, &out_, &nb, &n1, &n2, &S1, &S2,
                  &tc, &mirror, &scale, &scaled, &f};
  err = cudaLaunchCooperativeKernel((const void*)onepass_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
