// K7: the modular matrix product of the matmul NTT.
//
// Replaces: plonk_tpu/ops/pallas_mxu_ntt.py::_mont_matmul_kernel (called
// through mont_matmul_pallas from mxu_ntt_pallas / mxu_intt_pallas).
//
// Computes out = REDC64(X @ W~) for X (R, C) Montgomery words and
// W~[c, k] = w^{ck} * 2^64 mod p (C, K): out = (X @ W) * R mod p in
// Montgomery form, canonical. With a twiddle tw (T, K), R a multiple of T,
// row r of the result is then Montgomery-multiplied by tw[r mod T] (the TPU
// kernel's fused twiddle, without materialising the tiled table).
//
// Route: the TPU kernel's, on the int8 tensor cores. Both operands are
// split into four 7-bit limbs (the 27-bit r: words below 2^28), X_a and
// W_b, and the 16 limb products X_a W_b run as
// wgmma.mma_async.m64n32k32.s32.s8.s8 into seven s32 buckets
// B_k = sum_{a+b=k} X_a W_b; every bucket is below L * C * 127^2 < 2^31
// (the wrapper refuses C > 4096). The epilogue recomposes
// V = sum_k B_k 2^{7k} < 2^75 into 64 + 32 bits, reduces it by two 32-bit
// REDC steps, V * 2^-64 mod p < p + 2^12, and one conditional subtraction,
// so the words equal the TPU kernel's; then the fused twiddle.
// Design: one warpgroup (128 threads) per 64 x 32 output tile, so the
// seven buckets take 7 x 16 accumulator registers a thread. The
// contraction runs in chunks of 32 through a four-stage cp.async ring in
// shared memory, three chunks in flight: the block's X tile of int64 words
// (read once per block) and the constant limb planes of W~, from the
// wrapper's K-major copy (L, Kp, Cp) padded to multiples of 32 (8-bit
// wgmma reads B K-major only). Each chunk's X words are then split into
// four limb bytes and stored as the four int8 planes in wgmma's K-major
// layout (core matrices of 8 rows x 16 bytes, no swizzle), double
// buffered, so that the split of chunk ch + 1 runs while the tensor cores
// work on chunk ch.
// Bound on the H100: operations. At (2560, 512) x (4, 512, 512) the 16 limb
// products are 2^33.3 int8 operations, 0.011 ms at the int8 tensor cores'
// 1979 T/s; the int64 words in and out (21 MB) take 0.006 ms.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

constexpr int NL = 4;          // limb planes (7-bit limbs of a 28-bit word)
constexpr int NBK = 2 * NL - 1;  // buckets
constexpr int BM = 64;         // rows of a block tile (one warpgroup)
constexpr int BN = 32;         // columns of a block tile (wgmma N)
constexpr int BKC = 32;        // contraction chunk (wgmma K for 8-bit)
constexpr int STAGES = 4;      // cp.async ring of raw X and W~ chunks
constexpr int A_PLANE = BM * BKC;  // bytes of one A plane
constexpr int B_PLANE = BN * BKC;  // bytes of one B plane

// Dynamic shared memory: the ring of raw int64 X chunks and K-major W~
// planes, and two buffers of X's limb planes (96 KB, two blocks an SM).
struct Smem {
  long long xs[STAGES][BM * BKC];      // row-major, 16-byte chunks swizzled
  uint8_t b[STAGES][NL][B_PLANE];
  uint8_t a[2][NL][A_PLANE];
};

// Offset of (row, byte k) in a K-major tile of 32 bytes a row: core
// matrices of 8 rows x 16 bytes (128 contiguous bytes), the two k halves
// 128 bytes apart (LBO), groups of 8 rows 256 bytes apart (SBO).
__device__ __forceinline__ int kmajor_off(int row, int kb) {
  return (row >> 3) * 256 + (kb >> 4) * 128 + (row & 7) * 16 + (kb & 15);
}

// Word index in a raw X chunk of 16-byte chunk c (0..15) of row r: the
// chunk's low three bits are XORed with a key of (r, c >> 3), so that the
// eight threads of a quarter warp, reading chunk q of their 128-byte row
// halves, hit eight different bank groups.
__device__ __forceinline__ int xs_word(int r, int c) {
  const int key = ((r & 3) << 1) | (c >> 3);
  return r * BKC + 2 * ((c & 8) | ((c & 7) ^ key));
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  uint64_t d = 0;
  d |= (uint64_t)((addr >> 4) & 0x3FFF);           // start address
  d |= (uint64_t)(128 >> 4) << 16;                 // leading byte offset
  d |= (uint64_t)(256 >> 4) << 32;                 // stride byte offset
  return d;                                        // no swizzle, base 0
}

// d[0..15] += A (64 x 32 s8, desc da) * B^T (32 x 32 s8, desc db).
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// byte a of the result = limb a (7 bits) of w < 2^28
__device__ __forceinline__ uint32_t spread_limbs(uint32_t w) {
  return (w & 0x7Fu) | ((w << 1) & 0x7F00u) | ((w << 2) & 0x7F0000u) |
         ((w << 3) & 0x7F000000u);
}

// Starts the copies of chunk c0 (contraction words c0..c0+31) into ring
// stage st: the X tile's rows as 16-byte chunks (zero beyond R and C), and
// the W~ planes' 32 columns, and commits them as one group. With vec
// false (C odd or x not 16-byte aligned) the X words are stored directly.
__device__ __forceinline__ void load_chunk(const long long* __restrict__ x,
                                           const int8_t* __restrict__ wk,
                                           int R, int C, int Kp, int Cp,
                                           int row0, int col0, int c0,
                                           bool vec, Smem& sm, int st) {
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int q = threadIdx.x + 128 * rep;  // 4 planes x 32 rows x 2 halves
    const int l = q >> 6;
    const int n = (q & 63) >> 1;
    const int h = q & 1;
    cp_async16(sm.b[st][l] + kmajor_off(n, 16 * h),
               wk + ((size_t)l * Kp + col0 + n) * Cp + c0 + 16 * h, 16);
  }
  if (vec) {
#pragma unroll
    for (int rep = 0; rep < BM * BKC / 2 / 128; ++rep) {
      const int q = threadIdx.x + 128 * rep;  // 64 rows x 16 chunks
      const int r = q >> 4;
      const int c = q & 15;
      const int gr = row0 + r;
      const int gc = c0 + 2 * c;
      const bool in = gr < R && gc < C;
      cp_async16(sm.xs[st] + xs_word(r, c),
                 in ? x + (size_t)gr * C + gc : x, in ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < BM * BKC; q += 128) {
      const int r = q / BKC;
      const int w = q % BKC;
      const int gr = row0 + r;
      const int gc = c0 + w;
      sm.xs[st][xs_word(r, w >> 1) + (w & 1)] =
          gr < R && gc < C ? __ldg(x + (size_t)gr * C + gc) : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Splits ring stage st's X chunk into the four limb planes of buffer ab.
// Thread t: row t / 2, words 16 (t % 2) .. + 15, the 16-byte row segment
// of one core matrix in each plane.
__device__ __forceinline__ void split_chunk(Smem& sm, int st, int ab) {
  const int r = threadIdx.x >> 1;
  const int h = threadIdx.x & 1;
  uint32_t s[16];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const longlong2 v =
        *(const longlong2*)(sm.xs[st] + xs_word(r, 8 * h + q));
    s[2 * q] = spread_limbs((uint32_t)v.x);
    s[2 * q + 1] = spread_limbs((uint32_t)v.y);
  }
  // 4 x 4 byte transposes: plane a's word g = byte a of s[4g .. 4g + 3]
  uint32_t pw[NL][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t lo01 = __byte_perm(s[4 * g], s[4 * g + 1], 0x5140);
    const uint32_t hi01 = __byte_perm(s[4 * g], s[4 * g + 1], 0x7362);
    const uint32_t lo23 = __byte_perm(s[4 * g + 2], s[4 * g + 3], 0x5140);
    const uint32_t hi23 = __byte_perm(s[4 * g + 2], s[4 * g + 3], 0x7362);
    pw[0][g] = __byte_perm(lo01, lo23, 0x5410);
    pw[1][g] = __byte_perm(lo01, lo23, 0x7632);
    pw[2][g] = __byte_perm(hi01, hi23, 0x5410);
    pw[3][g] = __byte_perm(hi01, hi23, 0x7632);
  }
  const int off = kmajor_off(r, 16 * h);
#pragma unroll
  for (int l = 0; l < NL; ++l)
    *(uint4*)(sm.a[ab][l] + off) = make_uint4(pw[l][0], pw[l][1], pw[l][2],
                                              pw[l][3]);
}

__global__ void __launch_bounds__(128, 2)
    mont_matmul_kernel(const long long* __restrict__ x,
                       const int8_t* __restrict__ wk,
                       const long long* __restrict__ tw,
                       long long* __restrict__ out, int R, int C, int K,
                       int Kp, int Cp, int T, bool vec, MontParams f) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_chunks = Cp / BKC;

  int acc[NBK][16];
#pragma unroll
  for (int k = 0; k < NBK; ++k)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[k][j] = 0;

  // the ring holds chunks ch .. ch + STAGES - 2 in flight; a group is
  // committed for every stage, empty past the end, so that
  // cp.async.wait_group STAGES - 2 always means "chunk ch has landed"
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks)
      load_chunk(x, wk, R, C, Kp, Cp, row0, col0, st * BKC, vec, sm, st);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch % STAGES;
    const int ab = ch & 1;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    // buffer ab was last read by chunk ch - 2's products, waited for below
    split_chunk(sm, st, ab);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint64_t da[NL], db[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      da[l] = smem_desc(sm.a[ab][l]);
      db[l] = smem_desc(sm.b[st][l]);
    }
#pragma unroll
    for (int k = 0; k < NBK; ++k)
#pragma unroll
      for (int j = 0; j < 16; ++j) fence_operand(acc[k][j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ia = 0; ia < NL; ++ia)
#pragma unroll
      for (int ib = 0; ib < NL; ++ib) wgmma_s8(acc[ia + ib], da[ia], db[ib]);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // chunk ch - 1's products are done once at most this group is in
    // flight: its W~ stage (the one the next copy refills) and its plane
    // buffer are free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < NBK; ++k)
#pragma unroll
      for (int j = 0; j < 16; ++j) fence_operand(acc[k][j]);
    const int nxt = ch + STAGES - 1;
    if (nxt < n_chunks)
      load_chunk(x, wk, R, C, Kp, Cp, row0, col0, nxt * BKC, vec, sm,
                 nxt % STAGES);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < NBK; ++k)
#pragma unroll
    for (int j = 0; j < 16; ++j) fence_operand(acc[k][j]);

  // accumulator j of thread t: row 16 (t / 32) + (t % 32) / 4 + 8 (j % 4
  // / 2), column 8 (j / 4) + 2 (t % 4) + j % 2
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gr = row0 + 16 * warp + (lane >> 2) + 8 * ((j & 3) >> 1);
    const int gk = col0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    if (gr >= R || gk >= K) continue;
    // V = sum_k B_k 2^{7k} = lo + 2^64 hi (each B_k < 2^31)
    const uint64_t b0 = (uint32_t)acc[0][j], b1 = (uint32_t)acc[1][j],
                   b2 = (uint32_t)acc[2][j], b3 = (uint32_t)acc[3][j],
                   b4 = (uint32_t)acc[4][j];
    const uint64_t low = b0 + (b1 << 7) + (b2 << 14) + (b3 << 21) +
                         (b4 << 28);                       // < 2^62
    const uint64_t top = (uint64_t)(uint32_t)acc[5][j] +
                         ((uint64_t)(uint32_t)acc[6][j] << 7);  // < 2^39
    const uint64_t v_lo = low + (top << 35);
    const uint32_t v_hi = (uint32_t)(top >> 29) + (v_lo < low ? 1u : 0u);
    // first REDC: u = (V + m p) / 2^32 < 2^44
    const uint32_t m = (uint32_t)v_lo * f.n_prime;
    const uint64_t s = v_lo + (uint64_t)m * f.p;
    const uint64_t carry = s < v_lo;
    const uint64_t u = ((uint64_t)v_hi + carry) << 32 | (s >> 32);
    // second REDC: r = (u + m2 p) / 2^32 < p + 2^12
    const uint32_t m2 = (uint32_t)u * f.n_prime;
    uint32_t r = (uint32_t)((u + (uint64_t)m2 * f.p) >> 32);
    r = r >= f.p ? r - f.p : r;
    if (T > 0) r = mont_mul(r, (uint32_t)tw[(size_t)(gr % T) * K + gk], f);
    out[(size_t)gr * K + gk] = (long long)r;
  }
}

// x: (R, C) int64 words below 2^28; wk: (4, Kp, Cp) int8 7-bit limb planes
// of W~, K-major, zero-padded (Kp, Cp multiples of 32); tw: (T, K) int64
// or null with T = 0; out: (R, K) int64.
extern "C" int mont_matmul_launch(const void* x, const void* wk,
                                  const void* tw, void* out, int R, int C,
                                  int K, int Kp, int Cp, int T, unsigned p,
                                  unsigned n_prime, void* stream) {
  MontParams f{p, n_prime};
  dim3 grid((K + BN - 1) / BN, (R + BM - 1) / BM);
  const bool vec = (C % 2 == 0) && ((uintptr_t)x % 16 == 0);
  const int smem = (int)sizeof(Smem);
  // the opt-in above 48 KB is per device: set it on every call
  cudaError_t err = cudaFuncSetAttribute(
      mont_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mont_matmul_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const long long*)x, (const int8_t*)wk, (const long long*)tw,
      (long long*)out, R, C, K, Kp, Cp, T, vec, f);
  return (int)cudaGetLastError();
}
