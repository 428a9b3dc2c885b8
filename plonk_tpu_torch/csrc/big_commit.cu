// K4: fixed-base multi-commitment MSM over BN254 G1 (coordinates in Fq).
//
// Replaces: plonk_tpu/ops/pallas_bigmsm.py::_commit_kernel_v3 (called
// through big_commit_many_pallas from plonk_tpu/models/plonk_bn254.py::
// bn254_table_commit; v1 _commit_kernel and v2 compute the same points).
//
// Computes, for each of B commitments b, the Jacobian sum over points i and
// windows w of table[w][digit(b, w, i)][i], the affine entries of the
// window table T[w][d] = d * 2^(w*wb) * P_i (ops/bigcurve.py::
// build_big_table), read from the packed table of ops/bigcommit.py::
// pack_commit_table: (W, nb, L, 16) 32-bit limbs, x then y, Montgomery
// form, 64 contiguous bytes per entry. Each term's digit is read in the
// kernel from the scalar's standard-form 16-bit words, and taken as zero
// where the base point is infinity; a zero digit is the identity and is
// skipped. Entries with d >= 1 must be real points
// (true for a non-degenerate SRS), as the TPU kernel requires. Output:
// (3, B, 16) Jacobian words, canonical.
//
// Bound on the H100: integer multiply throughput. Each (b, w, i) term with
// a nonzero digit is one mixed Jacobian + affine addition, madd-2007-bl:
// 7 products and 4 squares. A 256-bit CIOS product is 64 + 64 wide
// 32x32->64 products, each two 32-bit multiply-adds on the card, plus 8 for
// the m_i: 264; a square (bigmont.cuh big_sqr_lazy) 36 + 64 wide products
// and the 8 m_i: 208. So a term is 2680 multiply-adds. An entry is 64
// bytes of value (x and y in Fq), read as four 16-byte loads; the nine
// commitments of a 2^12-gate proof select about half of the table's
// entries.
// Design: each thread reads table[w][digit][i] directly for its run of
// (window, point) terms and folds them into a register accumulator with
// complete mixed additions; a shared-memory tree reduces the block to one
// partial per (tile, commitment), and a second launch folds the tiles'
// partials per commitment. The grid is (B, n_tiles) with the commitment
// fastest, so the B blocks of one tile run together and share its digits'
// table rows in L2. Field values stay lazy, in [0, 2p), through the whole
// accumulation (bigmont.cuh) and are made canonical once, in the fold, as
// the TPU kernel's v3 does; so every zero test that picks the doubling or
// the inverse arm of an addition accepts 0 and p. Every addition handles
// the identity, doubling and inverse points, so any order of summation
// gives the same affine points as the plain version.
#include <cuda_runtime.h>
#include <cstdint>

#include "bigmont.cuh"

#define THREADS 128
#define MIN_BLOCKS 4  // blocks of THREADS per SM the tile kernel is sized for

struct Jac {
  uint32_t X[BIG_LIMBS], Y[BIG_LIMBS], Z[BIG_LIMBS];  // Z == 0: infinity
};

__device__ __forceinline__ void jac_set_inf(Jac& a, const U256& one) {
  big_copy(a.X, one.v);
  big_copy(a.Y, one.v);
#pragma unroll
  for (int k = 0; k < BIG_LIMBS; ++k) a.Z[k] = 0;
}

// a <- 2a for y^2 = x^3 + b (a = 0), dbl-2009-l, lazy values.
__device__ __forceinline__ void jac_double(Jac& a, const BigField& f) {
  uint32_t A[BIG_LIMBS], B[BIG_LIMBS], C[BIG_LIMBS], D[BIG_LIMBS],
      t[BIG_LIMBS];
  big_sqr_lazy(A, a.X, f);
  big_sqr_lazy(B, a.Y, f);
  big_mul_lazy(a.Z, a.Y, a.Z, f);
  big_add_lazy(a.Z, a.Z, a.Z, f);      // Z3 = 2YZ
  big_sqr_lazy(C, B, f);
  big_add_lazy(t, a.X, B, f);
  big_sqr_lazy(t, t, f);
  big_sub_lazy(t, t, A, f);
  big_sub_lazy(t, t, C, f);
  big_add_lazy(D, t, t, f);            // D = 2((X+B)^2 - A - C)
  big_add_lazy(B, A, A, f);
  big_add_lazy(B, B, A, f);            // E = 3A
  big_sqr_lazy(t, B, f);               // F = E^2
  big_sub_lazy(t, t, D, f);
  big_sub_lazy(a.X, t, D, f);          // X3 = F - 2D
  big_sub_lazy(t, D, a.X, f);
  big_mul_lazy(t, B, t, f);
  big_add_lazy(C, C, C, f);
  big_add_lazy(C, C, C, f);
  big_add_lazy(C, C, C, f);            // 8C
  big_sub_lazy(a.Y, t, C, f);          // Y3 = E(D - X3) - 8C
}

// a <- a + (x2, y2), the second operand an affine point (not infinity),
// madd-2007-bl (7 products, 4 squares), lazy values.
__device__ __forceinline__ void jac_add_affine(Jac& a,
                                               const uint32_t x2[BIG_LIMBS],
                                               const uint32_t y2[BIG_LIMBS],
                                               const BigField& f,
                                               const U256& one) {
  if (big_is_zero_lazy(a.Z, f)) {
    big_copy(a.X, x2);
    big_copy(a.Y, y2);
    big_copy(a.Z, one.v);
    return;
  }
  uint32_t t0[BIG_LIMBS], t1[BIG_LIMBS], t2[BIG_LIMBS], t3[BIG_LIMBS];
  big_sqr_lazy(t0, a.Z, f);            // Z1Z1
  big_mul_lazy(t1, x2, t0, f);         // U2
  big_sub_lazy(t1, t1, a.X, f);        // H = U2 - X1
  big_mul_lazy(t2, a.Z, t0, f);
  big_mul_lazy(t2, y2, t2, f);         // S2
  big_sub_lazy(t2, t2, a.Y, f);        // S2 - Y1
  if (big_is_zero_lazy(t1, f)) {
    if (big_is_zero_lazy(t2, f)) {
      jac_double(a, f);
    } else {
      jac_set_inf(a, one);
    }
    return;
  }
  big_add_lazy(t3, a.Z, t1, f);
  big_sqr_lazy(t3, t3, f);
  big_sub_lazy(t3, t3, t0, f);         // (Z1 + H)^2 - Z1Z1
  big_sqr_lazy(t0, t1, f);             // HH
  big_sub_lazy(a.Z, t3, t0, f);        // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  big_add_lazy(t0, t0, t0, f);
  big_add_lazy(t0, t0, t0, f);         // I = 4 HH
  big_mul_lazy(t1, t1, t0, f);         // J = H I
  big_mul_lazy(t0, a.X, t0, f);        // V = X1 I
  big_add_lazy(t2, t2, t2, f);         // r = 2 (S2 - Y1)
  big_sqr_lazy(t3, t2, f);
  big_sub_lazy(t3, t3, t1, f);
  big_sub_lazy(t3, t3, t0, f);
  big_sub_lazy(a.X, t3, t0, f);        // X3 = r^2 - J - 2V
  big_mul_lazy(t1, a.Y, t1, f);        // Y1 J
  big_sub_lazy(t0, t0, a.X, f);
  big_mul_lazy(t0, t2, t0, f);         // r (V - X3)
  big_add_lazy(t1, t1, t1, f);
  big_sub_lazy(a.Y, t0, t1, f);        // Y3 = r (V - X3) - 2 Y1 J
}

// a <- a + b, both Jacobian, lazy values; complete (add-2007-bl).
__device__ __noinline__ void jac_add(Jac& a, const Jac& b, const BigField& f,
                                     const U256& one) {
  if (big_is_zero_lazy(b.Z, f)) return;
  if (big_is_zero_lazy(a.Z, f)) {
    a = b;
    return;
  }
  uint32_t Z1Z1[BIG_LIMBS], Z2Z2[BIG_LIMBS], U1[BIG_LIMBS], S1[BIG_LIMBS],
      H[BIG_LIMBS], r[BIG_LIMBS], t[BIG_LIMBS];
  big_sqr_lazy(Z1Z1, a.Z, f);
  big_sqr_lazy(Z2Z2, b.Z, f);
  big_mul_lazy(U1, a.X, Z2Z2, f);
  big_mul_lazy(H, b.X, Z1Z1, f);
  big_sub_lazy(H, H, U1, f);           // H = U2 - U1
  big_mul_lazy(t, b.Z, Z2Z2, f);
  big_mul_lazy(S1, a.Y, t, f);
  big_mul_lazy(t, a.Z, Z1Z1, f);
  big_mul_lazy(r, b.Y, t, f);
  big_sub_lazy(r, r, S1, f);           // r = S2 - S1
  if (big_is_zero_lazy(H, f)) {
    if (big_is_zero_lazy(r, f)) {
      jac_double(a, f);
    } else {
      jac_set_inf(a, one);
    }
    return;
  }
  uint32_t HH[BIG_LIMBS], V[BIG_LIMBS];
  big_sqr_lazy(HH, H, f);
  big_mul_lazy(V, U1, HH, f);
  big_mul_lazy(HH, H, HH, f);          // HHH
  big_mul_lazy(a.Z, a.Z, b.Z, f);
  big_mul_lazy(a.Z, a.Z, H, f);        // Z3 = Z1 Z2 H
  big_sqr_lazy(t, r, f);
  big_sub_lazy(t, t, HH, f);
  big_sub_lazy(t, t, V, f);
  big_sub_lazy(a.X, t, V, f);          // X3 = r^2 - HHH - 2V
  big_sub_lazy(t, V, a.X, f);
  big_mul_lazy(t, r, t, f);
  big_mul_lazy(V, S1, HH, f);
  big_sub_lazy(a.Y, t, V, f);          // Y3 = r (V - X3) - S1 HHH
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

// grid (B, n_tiles): block (b, tile) sums the terms k = w * L + i in
// [tile * THREADS * ppt, (tile + 1) * THREADS * ppt) into partials[b][tile].
// The digit of term (w, i) is window w (wb bits) of scalar i of commitment
// b, read from its NW 16-bit words; 0 where i >= Ls or base point i is
// infinity.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    big_commit_tiles(const long long* __restrict__ scal,
                     const unsigned char* __restrict__ base_inf, int Ls,
                     int NW, int wb, const uint4* __restrict__ table, int W,
                     int nb, int L, int ppt, BigField f, U256 one,
                     Jac* __restrict__ partials, int n_tiles) {
  __shared__ Jac sh[THREADS];
  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const long long n_terms = (long long)W * L;
  Jac acc;
  jac_set_inf(acc, one);
  const long long base = (long long)tile * THREADS * ppt + threadIdx.x;
  const long long* sb = scal + (size_t)b * Ls * NW;
  for (int j = 0; j < ppt; ++j) {
    const long long k = base + (long long)j * THREADS;
    if (k >= n_terms) break;
    const int w = (int)(k / L);
    const int i = (int)(k - (long long)w * L);
    if (i >= Ls || __ldg(base_inf + i)) continue;
    const long long* s = sb + (size_t)i * NW;
    const int word = (w * wb) >> 4;
    const int off = (w * wb) & 15;
    uint32_t v = (uint32_t)__ldg(s + word) >> off;
    if (off + wb > 16 && word + 1 < NW)
      v |= (uint32_t)__ldg(s + word + 1) << (16 - off);
    const int d = (int)(v & (uint32_t)(nb - 1));
    if (d == 0) continue;
    const uint4* e = table + (((size_t)w * nb + d) * L + i) * 4;
    const uint4 q0 = __ldg(e), q1 = __ldg(e + 1), q2 = __ldg(e + 2),
                q3 = __ldg(e + 3);
    const uint32_t x[BIG_LIMBS] = {q0.x, q0.y, q0.z, q0.w,
                                   q1.x, q1.y, q1.z, q1.w};
    const uint32_t y[BIG_LIMBS] = {q2.x, q2.y, q2.z, q2.w,
                                   q3.x, q3.y, q3.z, q3.w};
    jac_add_affine(acc, x, y, f, one);
  }
  block_reduce(acc, sh, f, one);
  if (threadIdx.x == 0) partials[(size_t)b * n_tiles + tile] = acc;
}

// grid (B): folds partials[b][:] into out[:, b] (X, Y, Z words), canonical.
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
    big_csub(acc.X, acc.X, f);
    big_csub(acc.Y, acc.Y, f);
    big_csub(acc.Z, acc.Z, f);
    big_store(out + ((size_t)0 * B + b) * 16, acc.X);
    big_store(out + ((size_t)1 * B + b) * 16, acc.Y);
    big_store(out + ((size_t)2 * B + b) * 16, acc.Z);
  }
}

// scal (B, Ls, NW) int64 16-bit words, Ls <= L; base_inf (L) bool; table
// (W, nb, L, 16) int32 packed limbs (x then y), nb = 2^wb; partials:
// scratch of B * n_tiles Jac (n_tiles = ceil(W * L / (THREADS * ppt)));
// out (3, B, 16) int64 words.
extern "C" int big_commit_launch(const void* scal, const void* base_inf,
                                 int Ls, int NW, int wb, const void* table,
                                 int B, int W, int nb, int L, BigField f,
                                 U256 one, void* partials, int n_tiles,
                                 int ppt, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  big_commit_tiles<<<dim3(B, n_tiles), THREADS, 0, st>>>(
      (const long long*)scal, (const unsigned char*)base_inf, Ls, NW, wb,
      (const uint4*)table, W, nb, L, ppt, f, one, (Jac*)partials, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  big_commit_fold<<<B, THREADS, 0, st>>>((const Jac*)partials, n_tiles, f,
                                         one, (long long*)out);
  return (int)cudaGetLastError();
}
