// K4: fixed-base multi-commitment MSM over BN254 G1 (coordinates in Fq).
//
// Replaces: plonk_tpu/ops/pallas_bigmsm.py::_commit_kernel_v3 (called
// through big_commit_many_pallas from plonk_tpu/models/plonk_bn254.py::
// bn254_table_commit; v1 _commit_kernel and v2 compute the same points).
//
// Computes, for each of B commitments b, the Jacobian sum over points i and
// windows w of table[w][digit(b, w, i)][i], the affine entries of the
// window table T[w][d] = d * 2^(w*wb) * P_i (ops/bigcurve.py::
// build_big_table, layout (W, nb, L, 16) int64 words, Montgomery form).
// The digits (B, W, L) come from the wrapper, already zeroed where the base
// point is infinity; a zero digit is the identity and is skipped. Entries
// with d >= 1 must be real points (true for a non-degenerate SRS), as the
// TPU kernel requires. Output: (3, B, 16) Jacobian words.
//
// Bound on the H100: integer multiply throughput. Each (b, w, i) term with
// a nonzero digit is one mixed Jacobian + affine addition (11 Montgomery
// products, ~136 32-bit multiply-adds each). The bytes are smaller: an
// entry is 64 bytes of value (x and y in Fq), and the nine commitments of
// a 2^12-gate proof select about half of the table's entries. The port
// stores the 16-bit words in int64 (256 bytes per entry), and the kernel
// reads an entry once per commitment that selects it.
// Design: the TPU kernel swept all 16 buckets with masked selects (TPU
// gathers run element by element) and carried a running sum from one point
// tile to the next grid step; blocks on the card run in no order, so none
// of that carries over. Here each thread reads table[w][digit][i] directly
// for its run of (window, point) terms and folds them into a register
// accumulator with complete mixed additions; a shared-memory tree reduces
// the block to one partial per (tile, commitment), and a second launch
// folds the tiles' partials per commitment. Every addition handles the
// identity, doubling and inverse points, so any order of summation gives
// the same affine points as the plain version.
#include <cuda_runtime.h>
#include <cstdint>

#include "bigmont.cuh"

#define THREADS 128

struct Jac {
  uint32_t X[BIG_LIMBS], Y[BIG_LIMBS], Z[BIG_LIMBS];  // Z == 0: infinity
};

__device__ __forceinline__ void jac_set_inf(Jac& a, const U256& one) {
  big_copy(a.X, one.v);
  big_copy(a.Y, one.v);
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) a.Z[k] = 0;
}

// a <- 2a for y^2 = x^3 + b (a = 0), dbl-2009-l.
__device__ void jac_double(Jac& a, const BigField& f) {
  uint32_t A[BIG_LIMBS], B[BIG_LIMBS], C[BIG_LIMBS], D[BIG_LIMBS],
      E[BIG_LIMBS], t[BIG_LIMBS];
  big_mul(A, a.X, a.X, f);
  big_mul(B, a.Y, a.Y, f);
  big_mul(C, B, B, f);
  big_add(t, a.X, B, f);
  big_mul(t, t, t, f);
  big_sub(t, t, A, f);
  big_sub(t, t, C, f);
  big_add(D, t, t, f);                 // D = 2((X+B)^2 - A - C)
  big_add(E, A, A, f);
  big_add(E, E, A, f);                 // E = 3A
  big_mul(a.Z, a.Y, a.Z, f);
  big_add(a.Z, a.Z, a.Z, f);           // Z3 = 2YZ
  big_mul(t, E, E, f);                 // F = E^2
  big_sub(t, t, D, f);
  big_sub(a.X, t, D, f);               // X3 = F - 2D
  big_sub(t, D, a.X, f);
  big_mul(t, E, t, f);
  big_add(C, C, C, f);
  big_add(C, C, C, f);
  big_add(C, C, C, f);                 // 8C
  big_sub(a.Y, t, C, f);               // Y3 = E(D - X3) - 8C
}

// a <- a + (x2, y2), the second operand an affine point (not infinity).
__device__ void jac_add_affine(Jac& a, const uint32_t x2[BIG_LIMBS],
                               const uint32_t y2[BIG_LIMBS],
                               const BigField& f, const U256& one) {
  if (big_is_zero(a.Z)) {
    big_copy(a.X, x2);
    big_copy(a.Y, y2);
    big_copy(a.Z, one.v);
    return;
  }
  uint32_t Z1Z1[BIG_LIMBS], H[BIG_LIMBS], r[BIG_LIMBS], t[BIG_LIMBS],
      HH[BIG_LIMBS], V[BIG_LIMBS];
  big_mul(Z1Z1, a.Z, a.Z, f);
  big_mul(H, x2, Z1Z1, f);             // U2
  big_sub(H, H, a.X, f);               // H = U2 - X1
  big_mul(t, a.Z, Z1Z1, f);
  big_mul(r, y2, t, f);                // S2
  big_sub(r, r, a.Y, f);               // r = S2 - Y1
  if (big_is_zero(H)) {
    if (big_is_zero(r)) {
      jac_double(a, f);
    } else {
      jac_set_inf(a, one);
    }
    return;
  }
  big_mul(HH, H, H, f);
  big_mul(V, a.X, HH, f);              // V = X1 HH
  big_mul(HH, H, HH, f);               // HHH
  big_mul(a.Z, a.Z, H, f);             // Z3 = Z1 H
  big_mul(t, r, r, f);
  big_sub(t, t, HH, f);
  big_sub(t, t, V, f);
  big_sub(a.X, t, V, f);               // X3 = r^2 - HHH - 2V
  big_sub(t, V, a.X, f);
  big_mul(t, r, t, f);
  big_mul(V, a.Y, HH, f);
  big_sub(a.Y, t, V, f);               // Y3 = r(V - X3) - Y1 HHH
}

// a <- a + b, both Jacobian; complete.
__device__ void jac_add(Jac& a, const Jac& b, const BigField& f,
                        const U256& one) {
  if (big_is_zero(b.Z)) return;
  if (big_is_zero(a.Z)) {
    a = b;
    return;
  }
  uint32_t Z1Z1[BIG_LIMBS], Z2Z2[BIG_LIMBS], U1[BIG_LIMBS], S1[BIG_LIMBS],
      H[BIG_LIMBS], r[BIG_LIMBS], t[BIG_LIMBS];
  big_mul(Z1Z1, a.Z, a.Z, f);
  big_mul(Z2Z2, b.Z, b.Z, f);
  big_mul(U1, a.X, Z2Z2, f);
  big_mul(H, b.X, Z1Z1, f);
  big_sub(H, H, U1, f);                // H = U2 - U1
  big_mul(t, b.Z, Z2Z2, f);
  big_mul(S1, a.Y, t, f);
  big_mul(t, a.Z, Z1Z1, f);
  big_mul(r, b.Y, t, f);
  big_sub(r, r, S1, f);                // r = S2 - S1
  if (big_is_zero(H)) {
    if (big_is_zero(r)) {
      jac_double(a, f);
    } else {
      jac_set_inf(a, one);
    }
    return;
  }
  uint32_t HH[BIG_LIMBS], V[BIG_LIMBS];
  big_mul(HH, H, H, f);
  big_mul(V, U1, HH, f);
  big_mul(HH, H, HH, f);               // HHH
  big_mul(a.Z, a.Z, b.Z, f);
  big_mul(a.Z, a.Z, H, f);             // Z3 = Z1 Z2 H
  big_mul(t, r, r, f);
  big_sub(t, t, HH, f);
  big_sub(t, t, V, f);
  big_sub(a.X, t, V, f);
  big_sub(t, V, a.X, f);
  big_mul(t, r, t, f);
  big_mul(V, S1, HH, f);
  big_sub(a.Y, t, V, f);
}

// Reduce one Jac per thread to the block's thread 0 (blockDim.x ==
// THREADS, a power of two) through shared memory.
__device__ void block_reduce(Jac& acc, Jac* sh, const BigField& f,
                             const U256& one) {
  const int tid = threadIdx.x;
  sh[tid] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      Jac a = sh[tid];
      jac_add(a, sh[tid + s], f, one);
      sh[tid] = a;
    }
    __syncthreads();
  }
  acc = sh[0];
}

// grid (n_tiles, B): block (tile, b) sums the terms k = w * L + i in
// [tile * THREADS * ppt, (tile + 1) * THREADS * ppt) into partials[b][tile].
__global__ void big_commit_tiles(const int* __restrict__ digits,
                                 const long long* __restrict__ tx,
                                 const long long* __restrict__ ty, int W,
                                 int nb, int L, int ppt, BigField f, U256 one,
                                 Jac* __restrict__ partials, int n_tiles) {
  __shared__ Jac sh[THREADS];
  const int b = blockIdx.y;
  const long long n_terms = (long long)W * L;
  Jac acc;
  jac_set_inf(acc, one);
  const long long base = (long long)blockIdx.x * THREADS * ppt;
  for (int j = 0; j < ppt; ++j) {
    const long long k = base + (long long)j * THREADS + threadIdx.x;
    if (k >= n_terms) break;
    const int w = (int)(k / L);
    const int i = (int)(k - (long long)w * L);
    const int d = digits[((size_t)b * W + w) * L + i];
    if (d == 0) continue;
    const size_t e = (((size_t)w * nb + d) * L + i) * 16;
    uint32_t x[BIG_LIMBS], y[BIG_LIMBS];
    big_load(tx + e, x);
    big_load(ty + e, y);
    jac_add_affine(acc, x, y, f, one);
  }
  block_reduce(acc, sh, f, one);
  if (threadIdx.x == 0) partials[(size_t)b * n_tiles + blockIdx.x] = acc;
}

// grid (B): folds partials[b][:] into out[:, b] (X, Y, Z words).
__global__ void big_commit_fold(const Jac* __restrict__ partials, int n_tiles,
                                BigField f, U256 one,
                                long long* __restrict__ out) {
  __shared__ Jac sh[THREADS];
  const int b = blockIdx.x;
  const int B = gridDim.x;
  Jac acc;
  jac_set_inf(acc, one);
  for (int t = threadIdx.x; t < n_tiles; t += THREADS)
    jac_add(acc, partials[(size_t)b * n_tiles + t], f, one);
  block_reduce(acc, sh, f, one);
  if (threadIdx.x == 0) {
    big_store(out + ((size_t)0 * B + b) * 16, acc.X);
    big_store(out + ((size_t)1 * B + b) * 16, acc.Y);
    big_store(out + ((size_t)2 * B + b) * 16, acc.Z);
  }
}

// digits (B, W, L) int32; tx, ty (W, nb, L, 16) int64 words; partials:
// scratch of B * n_tiles Jac (n_tiles = ceil(W * L / (THREADS * ppt)));
// out (3, B, 16) int64 words.
extern "C" int big_commit_launch(const void* digits, const void* tx,
                                 const void* ty, int B, int W, int nb, int L,
                                 BigField f, U256 one, void* partials,
                                 int n_tiles, int ppt, void* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  big_commit_tiles<<<dim3(n_tiles, B), THREADS, 0, st>>>(
      (const int*)digits, (const long long*)tx, (const long long*)ty, W, nb,
      L, ppt, f, one, (Jac*)partials, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  big_commit_fold<<<B, THREADS, 0, st>>>((const Jac*)partials, n_tiles, f,
                                         one, (long long*)out);
  return (int)cudaGetLastError();
}
