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
// Bound on the H100: integer multiply throughput. Each (b, i, w) term with
// a nonzero digit costs one mixed addition (madd-2007-bl: 7 Montgomery
// products and 4 squares, each 4 32-bit multiply-adds by the yardstick of
// chip_smoke.py: a * b as a 32x32->64 product of two, m = lo(ab) n' and
// the high half of m p, one each); the selected table entries are 8 bytes
// of value each (x and y; infinity needs no byte of its own), read once
// per commitment and mostly from L2 after the first commitment. In SASS a
// product is IMAD.WIDE.U32, IMAD and IMAD.HI.U32 with a 64-bit addend,
// the wide forms slower than the yardstick's IMAD rate; chip_smoke.py
// --kernels times the product and the additions alone.
//
// Design. The TPU kernel swept every bucket d and selected by mask, because
// TPU gathers run element by element; a GPU thread reads table[w][d][i]
// directly. The kernel reads the table's packed copy (ops/commit.py
// pack_commit_table): one 64-bit word x | y << 32 per entry in Montgomery
// form, infinity the x = 0xFFFFFFFF that no coordinate takes (p < 2^31),
// half the bytes of the int64 table and one 8-byte load a term; its
// strides are the wrapper's (entries in (W, nb, L) order, which measured
// faster than (W, L, nb)). A digit d = 0 (row 0 is the identity by
// construction, as the TPU kernel relies on) is skipped without a load,
// and so is the padded top window, whose digits are 0. The scalars are
// read as their low 32-bit words. The table point is affine, so each term
// is a mixed addition, kept complete: the general formulas already give
// infinity for inverse points, an accumulator at infinity takes the point
// by a select, and only a doubling (the accumulator equal to the point)
// takes a branch; a sentinel entry skips the addition. Residues stay
// canonical (2p > 2^31, so a sum of two lazy residues would not fit 32
// bits).
// Blocks: b is the fastest block index, so the B commitments of a point
// tile run side by side and each table sector fetched from device memory
// serves them from L2; the tiles split the points evenly, the wrapper
// setting their count to one or two blocks an SM. A thread folds its
// points' terms into a register accumulator, each point's entries loaded
// while the previous point's terms are added; the block reduces through
// shared memory to one warp and that warp by shuffles, with complete
// additions. The last block to finish (an atomic ticket after a
// __threadfence) folds every tile's partial in a fixed order, so the
// launch is one and the Jacobian result deterministic; it resets the
// ticket for the next launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

constexpr int kThreads = 256;
constexpr int kMaxWindows = 8;
constexpr uint32_t kInfinity = 0xFFFFFFFFu;  // packed x of the identity

struct CurveConsts {
  MontParams f;
  uint32_t one, c2, c3, c8;  // Montgomery forms of 1, 2, 3, 8
};

struct Jac {
  uint32_t X, Y, Z;  // Z == 0 is the point at infinity
};

// Canonical arithmetic mod p < 2^31, a conditional subtraction as min().
__device__ __forceinline__ uint32_t fadd(uint32_t a, uint32_t b,
                                         uint32_t p) {
  const uint32_t s = a + b;
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t fsub(uint32_t a, uint32_t b,
                                         uint32_t p) {
  const uint32_t d = a - b;
  return min(d, d + p);
}

__device__ __forceinline__ uint32_t fmul(uint32_t a, uint32_t b,
                                         MontParams f) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * f.n_prime;
  const uint32_t r = (uint32_t)((t + (uint64_t)m * f.p) >> 32);
  return min(r, r - f.p);
}

__device__ __forceinline__ Jac jac_double(const CurveConsts& k, Jac a) {
  const MontParams f = k.f;
  const uint32_t p = f.p;
  uint32_t A = fmul(a.X, a.X, f);
  uint32_t B = fmul(a.Y, a.Y, f);
  uint32_t Cc = fmul(B, B, f);
  uint32_t t = fadd(a.X, B, p);
  uint32_t D = fmul(k.c2, fsub(fsub(fmul(t, t, f), A, p), Cc, p), f);
  uint32_t E = fmul(k.c3, A, f);
  uint32_t Ff = fmul(E, E, f);
  Jac r;
  r.X = fsub(Ff, fmul(k.c2, D, f), p);
  r.Y = fsub(fmul(E, fsub(D, r.X, p), f), fmul(k.c8, Cc, f), p);
  r.Z = fmul(k.c2, fmul(a.Y, a.Z, f), f);
  return r;
}

// Complete addition: identity operands, equal points (doubling) and
// inverse points (infinity) are all exact.
__device__ __forceinline__ Jac jac_add(const CurveConsts& k, Jac a, Jac b) {
  if (a.Z == 0) return b;
  if (b.Z == 0) return a;
  const MontParams f = k.f;
  const uint32_t p = f.p;
  uint32_t Z1Z1 = fmul(a.Z, a.Z, f);
  uint32_t Z2Z2 = fmul(b.Z, b.Z, f);
  uint32_t U1 = fmul(a.X, Z2Z2, f);
  uint32_t U2 = fmul(b.X, Z1Z1, f);
  uint32_t S1 = fmul(a.Y, fmul(b.Z, Z2Z2, f), f);
  uint32_t S2 = fmul(b.Y, fmul(a.Z, Z1Z1, f), f);
  uint32_t H = fsub(U2, U1, p);
  uint32_t r = fsub(S2, S1, p);
  if (H == 0) {
    if (r == 0) return jac_double(k, a);
    return Jac{k.one, k.one, 0u};
  }
  uint32_t HH = fmul(H, H, f);
  uint32_t HHH = fmul(H, HH, f);
  uint32_t V = fmul(U1, HH, f);
  Jac out;
  out.X = fsub(fsub(fmul(r, r, f), HHH, p), fadd(V, V, p), p);
  out.Y = fsub(fmul(r, fsub(V, out.X, p), f), fmul(S1, HHH, f), p);
  out.Z = fmul(fmul(a.Z, b.Z, f), H, f);
  return out;
}

// a + the packed affine entry e of a finite point, complete (madd-2007-bl:
// 7 products and 4 squares): an accumulator at infinity takes the point,
// inverse points give infinity (H = 0 makes Z3 = 0 in the general
// formulas) and equal points a doubling, the one case behind a branch.
// Written without other branches, so that the compiler can schedule a
// term's products freely.
__device__ __forceinline__ Jac jac_madd(const CurveConsts& k, Jac a,
                                        unsigned long long e) {
  const MontParams f = k.f;
  const uint32_t p = f.p;
  const uint32_t x2 = (uint32_t)e, y2 = (uint32_t)(e >> 32);
  const uint32_t Z1Z1 = fmul(a.Z, a.Z, f);
  const uint32_t U2 = fmul(x2, Z1Z1, f);
  const uint32_t S2 = fmul(y2, fmul(a.Z, Z1Z1, f), f);
  const uint32_t H = fsub(U2, a.X, p);
  const uint32_t r2 = fsub(S2, a.Y, p);  // r / 2
  const uint32_t HH = fmul(H, H, f);
  const uint32_t HH2 = fadd(HH, HH, p);
  const uint32_t I = fadd(HH2, HH2, p);
  const uint32_t J = fmul(H, I, f);
  const uint32_t r = fadd(r2, r2, p);
  const uint32_t V = fmul(a.X, I, f);
  Jac out;
  out.X = fsub(fsub(fmul(r, r, f), J, p), fadd(V, V, p), p);
  const uint32_t YJ = fmul(a.Y, J, f);
  out.Y = fsub(fmul(r, fsub(V, out.X, p), f), fadd(YJ, YJ, p), p);
  const uint32_t ZH = fadd(a.Z, H, p);
  out.Z = fsub(fsub(fmul(ZH, ZH, f), Z1Z1, p), HH, p);
  if (H == 0 && r2 == 0 && a.Z != 0) out = jac_double(k, a);
  if (a.Z == 0) out = Jac{x2, y2, k.one};
  return out;
}

__device__ __forceinline__ Jac shfl_down(Jac a, int off, int width) {
  return Jac{__shfl_down_sync(0xffffffffu, a.X, off, width),
             __shfl_down_sync(0xffffffffu, a.Y, off, width),
             __shfl_down_sync(0xffffffffu, a.Z, off, width)};
}

// Sum one Jac per thread of the block into thread 0's return value:
// shared memory down to one warp (each level in its own slots, so one
// barrier a level), then shuffles.
__device__ __forceinline__ Jac block_sum(const CurveConsts& k, Jac acc) {
  __shared__ uint32_t sx[kThreads], sy[kThreads], sz[kThreads];
  const int tid = threadIdx.x;
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    const int slot = kThreads - 2 * s + (tid - s);  // level s's s slots
    if (tid >= s && tid < 2 * s) {
      sx[slot] = acc.X;
      sy[slot] = acc.Y;
      sz[slot] = acc.Z;
    }
    __syncthreads();
    if (tid < s) {
      const int o = kThreads - 2 * s + tid;
      acc = jac_add(k, acc, Jac{sx[o], sy[o], sz[o]});
    }
  }
  if (tid < 32)
    for (int off = 16; off > 0; off >>= 1)
      acc = jac_add(k, acc, shfl_down(acc, off, 32));
  return acc;
}

// e[w] = the packed entry of point i in window w for the digits of s, the
// sentinel for a zero digit (row 0 is the identity: no load), a window
// past W or a point past the tile (!live); the loads are only issued.
__device__ __forceinline__ void load_terms(
    unsigned long long (&e)[kMaxWindows],
    const unsigned long long* __restrict__ table, long long sw,
    long long sd, long long si, int W, int wb, int i, uint32_t s,
    bool live) {
  const uint32_t dmask = (1u << wb) - 1;
#pragma unroll
  for (int w = 0; w < kMaxWindows; ++w) {
    const uint32_t d = live && w < W ? (s >> (w * wb)) & dmask : 0u;
    e[w] = d ? __ldg(table + w * sw + d * sd + i * si) : kInfinity;
  }
}

// grid (B * n_tiles); block x = b + B * tile sums commitment b's terms over
// the points [L * tile / n_tiles, L * (tile + 1) / n_tiles) into
// partials[:, b, tile]; the last block folds partials into out (3, B).
// A thread's points are kThreads apart; the next point's entries and the
// one after's scalar are on their way while a point's terms are added.
__global__ void __launch_bounds__(kThreads)
    commit_many_kernel(const uint32_t* __restrict__ scalars,
                       const unsigned long long* __restrict__ table,
                       long long sw, long long sd, long long si, int W,
                       int wb, int L, int n_tiles, CurveConsts k,
                       uint32_t* partials, unsigned* ticket,
                       long long* __restrict__ out) {
  const int B = gridDim.x / n_tiles;
  const int b = blockIdx.x % B;
  const int tile = blockIdx.x / B;
  const int tid = threadIdx.x;
  const int lo = (int)((long long)L * tile / n_tiles);
  const int hi = (int)((long long)L * (tile + 1) / n_tiles);
  // the low word of the int64 scalar (b, i)
  const uint32_t* sb = scalars + 2 * (size_t)b * L;
  int i = lo + tid;
  uint32_t s_next = i + kThreads < hi ? sb[2 * (i + kThreads)] : 0u;
  unsigned long long e[kMaxWindows];
  load_terms(e, table, sw, sd, si, W, wb, i, i < hi ? sb[2 * i] : 0u,
             i < hi);
  Jac acc{k.one, k.one, 0u};
  for (; i < hi; i += kThreads) {
    const int i1 = i + kThreads;
    unsigned long long e1[kMaxWindows];
    load_terms(e1, table, sw, sd, si, W, wb, i1, s_next, i1 < hi);
    s_next = i1 + kThreads < hi ? sb[2 * (i1 + kThreads)] : 0u;
    // the sentinel (a zero digit, the padded top window, an infinity
    // base) adds nothing; the top window's skip is uniform in a warp
#pragma unroll
    for (int w = 0; w < kMaxWindows; ++w)
      if ((uint32_t)e[w] != kInfinity) acc = jac_madd(k, acc, e[w]);
#pragma unroll
    for (int w = 0; w < kMaxWindows; ++w) e[w] = e1[w];
  }
  acc = block_sum(k, acc);
  __shared__ bool last;
  if (tid == 0) {
    partials[(0 * (size_t)B + b) * n_tiles + tile] = acc.X;
    partials[(1 * (size_t)B + b) * n_tiles + tile] = acc.Y;
    partials[(2 * (size_t)B + b) * n_tiles + tile] = acc.Z;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // groups of G lanes fold one commitment each: lane j adds tiles j, j + G,
  // ... in order (4 loads ahead), then the group's lanes by shuffles
  int G = 32;
  while (G > 1 && G * B > kThreads) G >>= 1;
  for (int b0 = 0; b0 < B; b0 += kThreads / G) {
    const int bb = b0 + tid / G;
    Jac sum{k.one, k.one, 0u};
    for (int t0 = tid % G; bb < B && t0 < n_tiles; t0 += 4 * G) {
      Jac q[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = t0 + m * G;
        const size_t at = (size_t)bb * n_tiles + t;
        q[m] = t < n_tiles
                   ? Jac{__ldcg(partials + at),
                         __ldcg(partials + (size_t)B * n_tiles + at),
                         __ldcg(partials + 2 * (size_t)B * n_tiles + at)}
                   : Jac{k.one, k.one, 0u};
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) sum = jac_add(k, sum, q[m]);
    }
    for (int off = G / 2; off > 0; off >>= 1)
      sum = jac_add(k, sum, shfl_down(sum, off, G));
    if (bb < B && tid % G == 0) {
      out[0 * B + bb] = sum.X;
      out[1 * B + bb] = sum.Y;
      out[2 * B + bb] = sum.Z;
    }
  }
  if (tid == 0) *ticket = 0;
}

// scalars (B, L) int64 standard form; table: the packed entries, entry
// (w, d, i) at word w * sw + d * sd + i * si; W <= kMaxWindows windows of
// wb bits (W * wb <= 32); partials (3, B, n_tiles) uint32 scratch; ticket
// one uint32 that is 0 between launches; out (3, B) int64.
extern "C" int commit_many_launch(const void* scalars, const void* table,
                                  long long sw, long long sd, long long si,
                                  int B, int W, int wb, int L, unsigned p,
                                  unsigned n_prime, unsigned one,
                                  unsigned c2, unsigned c3, unsigned c8,
                                  void* partials, int n_tiles, void* ticket,
                                  void* out, void* stream) {
  CurveConsts k{MontParams{p, n_prime}, one, c2, c3, c8};
  commit_many_kernel<<<B * n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, (const unsigned long long*)table, sw, sd, si,
      W, wb, L, n_tiles, k, (uint32_t*)partials, (unsigned*)ticket,
      (long long*)out);
  return (int)cudaGetLastError();
}
