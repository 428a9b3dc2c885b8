// K2: fixed-base multi-commitment MSM over the scaled curve.
//
// Replaces: plonk_tpu/ops/pallas_msm.py::_commit_kernel (called through
// commit_many_pallas / msm_fixed_base_many_pallas from
// plonk_tpu/models/plonk_scaled.py::table_commit).
//
// Computes, for each of B commitments b, the Jacobian sum over points i and
// windows w of table[w][digit(s_bi, w)][i], digit = (s >> w*wb) & (nb-1),
// against the window table of build_commit_table (layout (W, nb, L), row
// d = 0 the identity, padded windows all identity).
//
// Bound on the H100: integer multiply throughput. Each (b, i, w) term costs
// one complete Jacobian addition (~16 Montgomery products, each 4 32-bit
// multiply-adds: a * b as a 32x32->64 product of two, m = lo(ab) n' and
// the high half of m p, one each); the
// selected table entries are 9 bytes of value each (x, y, infinity flag;
// 17 in the port's int64 storage), read once per commitment and mostly
// from L2 after the first commitment.
// Design: the TPU kernel swept every bucket d and selected by mask, because
// TPU gathers run element by element; a GPU thread reads
// table[w][digit][i] directly, so there is no sweep. Grid = (point tiles,
// commitments); each thread folds its points' terms into a register
// accumulator, a shared-memory tree reduces the block to one partial, and
// a second small launch folds the tiles' partials per commitment. The
// addition is complete (identity, doubling, inverse points), so every
// reduction order gives the same affine point. Points past L are skipped
// rather than padded with identity entries and zero scalars as on the TPU.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

#define THREADS 256

struct CurveConsts {
  MontParams f;
  uint32_t one, c2, c3, c8;  // Montgomery forms of 1, 2, 3, 8
};

struct Jac {
  uint32_t X, Y, Z;  // Z == 0 is the point at infinity
};

__device__ __forceinline__ Jac jac_double(const CurveConsts& k, Jac a) {
  const MontParams f = k.f;
  const uint32_t p = f.p;
  uint32_t A = mont_mul(a.X, a.X, f);
  uint32_t B = mont_mul(a.Y, a.Y, f);
  uint32_t Cc = mont_mul(B, B, f);
  uint32_t t = mont_add(a.X, B, p);
  uint32_t D = mont_mul(
      k.c2, mont_sub(mont_sub(mont_mul(t, t, f), A, p), Cc, p), f);
  uint32_t E = mont_mul(k.c3, A, f);
  uint32_t Ff = mont_mul(E, E, f);
  Jac r;
  r.X = mont_sub(Ff, mont_mul(k.c2, D, f), p);
  r.Y = mont_sub(mont_mul(E, mont_sub(D, r.X, p), f), mont_mul(k.c8, Cc, f),
                 p);
  r.Z = mont_mul(k.c2, mont_mul(a.Y, a.Z, f), f);
  return r;
}

// Complete addition: identity operands, equal points (doubling) and
// inverse points (infinity) are all exact.
__device__ __forceinline__ Jac jac_add(const CurveConsts& k, Jac a, Jac b) {
  if (a.Z == 0) return b;
  if (b.Z == 0) return a;
  const MontParams f = k.f;
  const uint32_t p = f.p;
  uint32_t Z1Z1 = mont_mul(a.Z, a.Z, f);
  uint32_t Z2Z2 = mont_mul(b.Z, b.Z, f);
  uint32_t U1 = mont_mul(a.X, Z2Z2, f);
  uint32_t U2 = mont_mul(b.X, Z1Z1, f);
  uint32_t S1 = mont_mul(a.Y, mont_mul(b.Z, Z2Z2, f), f);
  uint32_t S2 = mont_mul(b.Y, mont_mul(a.Z, Z1Z1, f), f);
  uint32_t H = mont_sub(U2, U1, p);
  uint32_t r = mont_sub(S2, S1, p);
  if (H == 0) {
    if (r == 0) return jac_double(k, a);
    return Jac{k.one, k.one, 0u};
  }
  uint32_t HH = mont_mul(H, H, f);
  uint32_t HHH = mont_mul(H, HH, f);
  uint32_t V = mont_mul(U1, HH, f);
  Jac out;
  out.X = mont_sub(mont_sub(mont_mul(r, r, f), HHH, p),
                   mont_mul(k.c2, V, f), p);
  out.Y = mont_sub(mont_mul(r, mont_sub(V, out.X, p), f),
                   mont_mul(S1, HHH, f), p);
  out.Z = mont_mul(mont_mul(a.Z, b.Z, f), H, f);
  return out;
}

// Reduce one Jac per thread to sh[0] (blockDim.x == THREADS, a power of 2).
__device__ __forceinline__ Jac block_reduce(const CurveConsts& k, Jac acc,
                                            uint32_t* sh) {
  uint32_t* sx = sh;
  uint32_t* sy = sh + THREADS;
  uint32_t* sz = sh + 2 * THREADS;
  const int tid = threadIdx.x;
  sx[tid] = acc.X;
  sy[tid] = acc.Y;
  sz[tid] = acc.Z;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      Jac o = jac_add(k, Jac{sx[tid], sy[tid], sz[tid]},
                      Jac{sx[tid + s], sy[tid + s], sz[tid + s]});
      sx[tid] = o.X;
      sy[tid] = o.Y;
      sz[tid] = o.Z;
    }
    __syncthreads();
  }
  return Jac{sx[0], sy[0], sz[0]};
}

// grid (n_tiles, B); each block sums the terms of tile * THREADS * ppt ..
// (tile + 1) * THREADS * ppt - 1 into partials[:, b, tile].
__global__ void commit_tiles_kernel(const long long* __restrict__ scalars,
                                    const long long* __restrict__ tx,
                                    const long long* __restrict__ ty,
                                    const bool* __restrict__ tinf, int W,
                                    int nb, int L, int wb, int ppt,
                                    CurveConsts k,
                                    uint32_t* __restrict__ partials,
                                    int n_tiles) {
  __shared__ uint32_t sh[3 * THREADS];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int B = gridDim.y;
  Jac acc{k.one, k.one, 0u};
  const long long base = (long long)tile * THREADS * ppt;
  for (int j = 0; j < ppt; ++j) {
    const long long i = base + (long long)j * THREADS + threadIdx.x;
    if (i >= L) break;
    const uint32_t s = (uint32_t)scalars[(size_t)b * L + i];
    for (int w = 0; w < W; ++w) {
      const uint32_t d = (s >> (w * wb)) & (uint32_t)(nb - 1);
      const size_t idx = ((size_t)w * nb + d) * L + i;
      if (!tinf[idx])
        acc = jac_add(k, acc, Jac{(uint32_t)tx[idx], (uint32_t)ty[idx],
                                  k.one});
    }
  }
  Jac sum = block_reduce(k, acc, sh);
  if (threadIdx.x == 0) {
    partials[((size_t)0 * B + b) * n_tiles + tile] = sum.X;
    partials[((size_t)1 * B + b) * n_tiles + tile] = sum.Y;
    partials[((size_t)2 * B + b) * n_tiles + tile] = sum.Z;
  }
}

// grid (B); folds partials[:, b, :] into out[:, b] (int64 X, Y, Z).
__global__ void fold_partials_kernel(const uint32_t* __restrict__ partials,
                                     int n_tiles, CurveConsts k,
                                     long long* __restrict__ out) {
  __shared__ uint32_t sh[3 * THREADS];
  const int b = blockIdx.x;
  const int B = gridDim.x;
  Jac acc{k.one, k.one, 0u};
  for (int t = threadIdx.x; t < n_tiles; t += THREADS) {
    Jac q{partials[((size_t)0 * B + b) * n_tiles + t],
          partials[((size_t)1 * B + b) * n_tiles + t],
          partials[((size_t)2 * B + b) * n_tiles + t]};
    acc = jac_add(k, acc, q);
  }
  Jac sum = block_reduce(k, acc, sh);
  if (threadIdx.x == 0) {
    out[0 * B + b] = sum.X;
    out[1 * B + b] = sum.Y;
    out[2 * B + b] = sum.Z;
  }
}

// scalars (B, L) int64 standard form; tx, ty (W, nb, L) int64 Montgomery;
// tinf (W, nb, L) bool; partials (3, B, n_tiles) 32-bit scratch with
// n_tiles = ceil(L / (THREADS * ppt)); out (3, B) int64.
extern "C" int commit_many_launch(const void* scalars, const void* tx,
                                  const void* ty, const void* tinf, int B,
                                  int W, int nb, int L, int wb, unsigned p,
                                  unsigned n_prime, unsigned one,
                                  unsigned c2, unsigned c3, unsigned c8,
                                  void* partials, int n_tiles, int ppt,
                                  void* out, void* stream) {
  CurveConsts k{MontParams{p, n_prime}, one, c2, c3, c8};
  cudaStream_t st = (cudaStream_t)stream;
  commit_tiles_kernel<<<dim3(n_tiles, B), THREADS, 0, st>>>(
      (const long long*)scalars, (const long long*)tx, (const long long*)ty,
      (const bool*)tinf, W, nb, L, wb, ppt, k, (uint32_t*)partials,
      n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_partials_kernel<<<B, THREADS, 0, st>>>((const uint32_t*)partials,
                                              n_tiles, k, (long long*)out);
  return (int)cudaGetLastError();
}
