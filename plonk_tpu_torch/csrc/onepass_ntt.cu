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
// With the pair (lo, hi = lo + half) of the stage with distance half and
// the lane twiddle w = tw[s][hi] (the tables hold w on both lanes):
//   DIF: lo <- lo + hi,        hi <- (lo - hi) * w
//   DIT: lo <- lo + hi * w,    hi <- lo - hi * w
//
// Bound on the H100: device memory. Each word is read once and written once
// (4 bytes of value each; the port's int64 I/O moves 8, a floor above the
// values' bound), the uint32 tables once; the Montgomery products take a
// little less time at (5, 512, 512). The scratch round trip between the
// passes stays in L2.
//
// Design. The TPU kernel keeps the whole matrix (1 MB of 31-bit words at
// 2^18) in VMEM; no H100 block holds that, so the kernel is one
// cooperative launch with one grid.sync() between two passes over an
// L2-resident scratch (the output array, transformed in place by the
// second pass); timed apart, that launch and barrier cost about 0.004 ms,
// a small part of the old kernel's 0.13. Each pass works on tiles of
// whole transforms of at most 2048 words: the axis-0 pass on column tiles
// of n1 rows by 4 columns (128 tiles at nb = 1 and 512 x 512, so every SM
// has work; 640 at nb = 5), the axis-1 pass on tiles of 4 rows. A tile's
// positions q are bits: the element index of its transforms sits at bits
// [eoff, eoff + S), the columns or rows elsewhere. The stages run in
// radix-8 register rounds: thread g holds the 8 positions of group g that
// differ in three q bits, runs the three stages of those bits on its
// registers, and the tile goes through shared memory between rounds (three
// rounds and two exchanges for 512 points instead of nine barriers; S mod
// 3 stages take a shorter round on the lowest element bits, whose spare
// register bits take other q bits). The host fixes each round's positions
// and passes them in the launch's __grid_constant__ geometry. The first
// round's words come from device memory (16-byte loads where a thread's
// neighbouring registers are neighbouring words) and the last round
// stores there, with the middle twiddle or the 1/n scale fused into the
// store; a block walks its tiles (3 blocks an SM) with the next tile's
// words loading while it transforms the current one. Words stay below 2p
// through the stages and between the passes (Harvey's lazy butterflies,
// for p < 2^30) and become canonical at the last store. The lane twiddles
// are uint32 tables packed once by the wrapper; the block copies the last
// stage's lanes, every power of the root, to shared memory, and a round
// reads the 7 distinct twiddles of its 12 butterflies once. Shared memory
// is swizzled (q ^ (q >> 5) & 31) and the group index is spread over q
// bits of distinct residues mod 5, so that a warp's 32 accesses hit 32
// banks in every round. The SM count and the occupancy are queried once
// per device.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTileWords = 2048;     // a tile's words: 8 KB, 8 a thread
constexpr int kBlocksPerSm = 3;      // blocks launched per SM
constexpr int kMaxDevices = 64;

constexpr int kMaxRounds = 4;       // ceil(log2(kTileWords) / 3)
constexpr int kGroupBits = 8;       // log2(kTileWords / 8)

// The tile positions of a round, fixed by the host: register k of group
// g holds position base | qoff[k], where base puts bit i of g on q bit
// gpos[i]. The low five bits of g go to q bits of distinct residues mod 5,
// which the shared-memory swizzle turns into distinct banks.
struct RoundPlan {
  int b, glo;                // stage bits in registers; element bit of reg 0
  uint32_t qoff[8];          // tile position of register k (base = 0)
  uint32_t soff[8];          // its shared-memory word, swz(qoff[k])
  uint32_t woff[8];          // its word offset in device memory
  int gpos[kGroupBits];
};

// One axis pass: its transforms, tiles and rounds.
struct PassGeom {
  int S;       // stages: log2 of the transform length
  int eoff;    // q bit of the element index's bit 0
  int cbits;   // log2 of the columns (column tile) or rows (row tile)
  int wq;      // q bits of a tile (>= 3; positions past its words are empty)
  int column;  // column tiles (axis 0) or row tiles (axis 1)
  int tiles;
  int nr;      // rounds; plan[g] is the round of element-bit group g
  RoundPlan plan[kMaxRounds];
};

struct Geometry {
  PassGeom axis0, axis1;
  int n1, n2;
  long long rows;  // nb * n1
  int tile_words;  // shared words of a tile; the root's powers follow
};

__host__ __device__ __forceinline__ uint32_t swz(uint32_t q) {
  return q ^ ((q >> 5) & 31);
}

// Offset of tile position q from the tile's first word in device memory.
__host__ __device__ __forceinline__ uint32_t word_off(const PassGeom& P,
                                                      int n2, uint32_t q) {
  if (!P.column) return q;
  return (q >> P.cbits) * (uint32_t)n2 + (q & ((1u << P.cbits) - 1));
}

// The tile position of register 0 for group index g.
__device__ __forceinline__ uint32_t group_base(const RoundPlan& R,
                                               uint32_t g) {
  uint32_t base = 0;
#pragma unroll
  for (int i = 0; i < kGroupBits; ++i) base |= (g >> i & 1u) << R.gpos[i];
  return base;
}

// Lazy residues, as in Harvey's butterflies: words stay below 2p between
// stages and between the passes, and become canonical at the last store.
// That needs 4p < 2^32 (the wrapper checks p < 2^30). A word below 4p
// times a canonical one, without mont_mul's final subtraction, is below
// 2p: (4p * p + 2^32 p) / 2^32 < 2p.
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t b,
                                             MontParams f) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * f.n_prime;
  return (uint32_t)((t + (uint64_t)m * f.p) >> 32);
}

// a mod m for a < 2m.
__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t m) {
  return a >= m ? a - m : a;
}

// Shared-memory slot of power i: one pad word every 32, so that a warp's
// reads at a power-of-two stride spread over the banks.
__device__ __forceinline__ uint32_t pw_slot(uint32_t i) {
  return i + (i >> 5);
}

// The B stages of a round on registers v (register bit e holds element
// bit glo + e, e < B), DIF from the highest bit down or DIT up; ebase is
// the element index of register 0 and pw the len/2 powers of the root, so
// that the lane twiddle of stage s at lane j is pw[(j mod 2^s) << (S-1-s)].
// The twiddle of stage e depends only on the element bits below it, so
// 2^e reads serve its 4 butterflies.
template <int B, bool DIF>
__device__ __forceinline__ void radix_round(uint32_t (&v)[8],
                                            const uint32_t* pw, int S,
                                            int glo, uint32_t ebase,
                                            MontParams f) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int e = DIF ? B - 1 - i : i;
    const int s = glo + e;
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < (1 << e); ++m) {
      const uint32_t power = ((ebase | (m << glo)) & ((1u << s) - 1))
                             << (S - 1 - s);
      w[m] = pw[pw_slot(power)];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k & (1 << e)) continue;
      const int h = k | (1 << e);
      const uint32_t wk = w[k & ((1 << e) - 1)];
      const uint32_t p2 = f.p << 1;
      if (DIF) {
        const uint32_t a = v[k], b = v[h];
        v[k] = csub(a + b, p2);
        v[h] = mul_lazy(a - b + p2, wk, f);
      } else {
        const uint32_t u = mul_lazy(v[h], wk, f);
        v[h] = csub(v[k] - u + p2, p2);
        v[k] = csub(v[k] + u, p2);
      }
    }
  }
}

// A tile's first word in device memory and how many of its positions
// hold words (the last row tile may be short).
__device__ __forceinline__ void tile_span(const PassGeom& P,
                                          const Geometry& G, int tile,
                                          size_t& origin, uint32_t& valid) {
  if (P.column) {
    const int per_mat = G.n2 >> P.cbits;
    origin = (size_t)(tile / per_mat) * G.n1 * G.n2 +
             ((size_t)(tile % per_mat) << P.cbits);
    valid = (uint32_t)G.n1 << P.cbits;
  } else {
    const long long row0 = (long long)tile << P.cbits;
    const long long left = G.rows - row0;
    origin = (size_t)row0 * G.n2;
    valid = (uint32_t)((left < (1ll << P.cbits) ? left : 1ll << P.cbits) *
                       G.n2);
  }
}

// v[k] = the word at position base | qoff[k] of the tile at `at` (0 past
// the tile's words); 16-byte loads when registers k, k + 1 are neighbours.
__device__ __forceinline__ void load_words(uint32_t (&v)[8],
                                           const long long* src, size_t at,
                                           uint32_t base, uint32_t valid,
                                           const RoundPlan& R, bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      longlong2 x = make_longlong2(0, 0);
      if ((base | R.qoff[k]) < valid)
        x = *reinterpret_cast<const longlong2*>(src + at + R.woff[k]);
      v[k] = (uint32_t)x.x;
      v[k + 1] = (uint32_t)x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (base | R.qoff[k]) < valid ? (uint32_t)src[at + R.woff[k]] : 0u;
  }
}

// One axis pass over every tile: src -> dst (both nb matrices (n1, n2);
// src may be dst), words below 2p in and out, canonical out if `final`.
// The result is multiplied by twm (n1, n2) if given, then by `scale` if
// scaled. Thread g holds group g of every round (a tile has
// at most kThreads groups); a block walks its tiles with the next tile's
// words already on their way while it transforms the current one.
__device__ void axis_pass(const long long* src, long long* dst, uint32_t* sm,
                          const PassGeom& P, const Geometry& G,
                          const uint32_t* __restrict__ tw, bool dif,
                          const uint32_t* __restrict__ twm, uint32_t scale,
                          bool scaled, bool final, MontParams f) {
  const int len = 1 << P.S;
  const int nr = P.nr;
  const uint32_t g = threadIdx.x;
  const bool active = g < (1u << (P.wq - 3));
  const uint32_t mat_mask = (uint32_t)G.n1 * G.n2 - 1;
  const bool vec_ok = ((reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                      (!P.column || P.cbits >= 1);
  const RoundPlan& R0 = P.plan[dif ? nr - 1 : 0];  // the first round
  const RoundPlan& RL = P.plan[dif ? 0 : nr - 1];  // the last round
  const uint32_t base0 = group_base(R0, g), baseL = group_base(RL, g);
  const bool vec0 = vec_ok && R0.qoff[1] == 1, vecL = vec_ok && RL.qoff[1] == 1;
  uint32_t next[8];
  if (active && (int)blockIdx.x < P.tiles) {
    size_t origin;
    uint32_t valid;
    tile_span(P, G, blockIdx.x, origin, valid);
    load_words(next, src, origin + word_off(P, G.n2, base0), base0, valid,
               R0, vec0);
  }
  // the last stage's lanes 0 .. len/2 - 1 hold every power of the root
  uint32_t* pw = sm + G.tile_words;
  for (int i = threadIdx.x; i < len / 2; i += blockDim.x)
    pw[pw_slot(i)] = __ldg(tw + (size_t)(P.S - 1) * len + i);
  __syncthreads();
  for (int tile = blockIdx.x; tile < P.tiles; tile += gridDim.x) {
    size_t origin;
    uint32_t valid;  // positions q < valid hold words
    tile_span(P, G, tile, origin, valid);
    // this tile's middle twiddles and the next tile's words go out before
    // the words already on their way are waited for
    const size_t atL = origin + word_off(P, G.n2, baseL);
    uint32_t tm[8];
    if (active && twm != nullptr) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        tm[k] = (baseL | RL.qoff[k]) < valid
                    ? __ldg(twm + ((atL + RL.woff[k]) & mat_mask)) : 0u;
    }
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = next[k];
    if (active && tile + (int)gridDim.x < P.tiles) {
      size_t o;
      uint32_t va;
      tile_span(P, G, tile + gridDim.x, o, va);
      load_words(next, src, o + word_off(P, G.n2, base0), base0, va, R0,
                 vec0);
    }
    for (int r = 0; r < nr; ++r) {
      const RoundPlan& R = P.plan[dif ? nr - 1 - r : r];
      const bool last = r == nr - 1;
      const uint32_t base =
          r == 0 ? base0 : (last ? baseL : group_base(R, g));
      const uint32_t sbase = swz(base);
      if (active) {
        if (r > 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = sm[sbase ^ R.soff[k]];
        }
        const uint32_t ebase = (base >> P.eoff) & (len - 1);
        switch (R.b * 2 + (dif ? 1 : 0)) {
          case 2: radix_round<1, false>(v, pw, P.S, R.glo, ebase, f); break;
          case 3: radix_round<1, true>(v, pw, P.S, R.glo, ebase, f); break;
          case 4: radix_round<2, false>(v, pw, P.S, R.glo, ebase, f); break;
          case 5: radix_round<2, true>(v, pw, P.S, R.glo, ebase, f); break;
          case 6: radix_round<3, false>(v, pw, P.S, R.glo, ebase, f); break;
          case 7: radix_round<3, true>(v, pw, P.S, R.glo, ebase, f); break;
          default: break;  // S = 0: the twiddle and scale alone
        }
        if (last) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (twm != nullptr) v[k] = mul_lazy(v[k], tm[k], f);
            if (scaled) v[k] = mul_lazy(v[k], scale, f);
            if (final) v[k] = csub(v[k], f.p);
          }
          if (vecL) {
#pragma unroll
            for (int k = 0; k < 8; k += 2)
              if ((baseL | RL.qoff[k]) < valid)
                *reinterpret_cast<longlong2*>(dst + atL + RL.woff[k]) =
                    make_longlong2((long long)v[k], (long long)v[k + 1]);
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if ((baseL | RL.qoff[k]) < valid)
                dst[atL + RL.woff[k]] = (long long)v[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) sm[sbase ^ R.soff[k]] = v[k];
        }
      }
      __syncthreads();  // the next round (or tile) reads what this wrote
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    onepass_kernel(const long long* y, const uint32_t* __restrict__ tw1,
                   const uint32_t* __restrict__ twm,
                   const uint32_t* __restrict__ tw2, long long* out,
                   const __grid_constant__ Geometry G, int mirror,
                   uint32_t scale, int scaled,
                   int passes, MontParams f) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  if (!mirror) {
    if (passes & 1)
      axis_pass(y, out, sm, G.axis0, G, tw1, true, twm, 0, false, false, f);
    if (passes & 2) grid.sync();
    if (passes & 4)
      axis_pass(out, out, sm, G.axis1, G, tw2, true, nullptr, 0, false, true,
                f);
  } else {
    if (passes & 1)
      axis_pass(y, out, sm, G.axis1, G, tw2, false, twm, 0, false, false, f);
    if (passes & 2) grid.sync();
    if (passes & 4)
      axis_pass(out, out, sm, G.axis0, G, tw1, false, nullptr, scale,
                scaled != 0, true, f);
  }
}

static int log2i(long long v) {
  int s = 0;
  while ((1ll << s) < v) ++s;
  return s;
}

static PassGeom pass_geom(int S, int cbits, bool column, int tiles, int n2) {
  PassGeom P;
  P.S = S;
  P.cbits = cbits;
  P.column = column;
  P.eoff = column ? cbits : 0;
  P.wq = S + cbits < 3 ? 3 : S + cbits;
  P.tiles = tiles;
  // element-bit groups: 3 bits each from the top, S mod 3 (or 3) at 0
  P.nr = S == 0 ? 1 : (S + 2) / 3;
  const int b0 = S == 0 ? 0 : S - 3 * (P.nr - 1);
  for (int grp = 0; grp < P.nr; ++grp) {
    RoundPlan& R = P.plan[grp];
    R.b = grp == 0 ? b0 : 3;
    R.glo = grp == 0 ? 0 : b0 + 3 * (grp - 1);
    uint32_t used = 0;
    int qpos[3];
    for (int e = 0; e < 3; ++e) {
      qpos[e] = P.eoff + R.glo + e;
      if (e >= R.b) {  // a spare register bit: the lowest free q bit
        qpos[e] = 0;
        while ((used >> qpos[e] & 1) ||
               (qpos[e] >= P.eoff + R.glo && qpos[e] < P.eoff + R.glo + R.b))
          ++qpos[e];
      }
      used |= 1u << qpos[e];
    }
    for (int k = 0; k < 8; ++k) {
      R.qoff[k] = ((k & 1u) << qpos[0]) | ((k >> 1 & 1u) << qpos[1]) |
                  ((k >> 2 & 1u) << qpos[2]);
      R.soff[k] = swz(R.qoff[k]);
      R.woff[k] = word_off(P, n2, R.qoff[k]);
    }
    int i = 0;
    for (int r = 0; r < 5; ++r)
      for (int pos = r; pos < P.wq && pos < 10; pos += 5)
        if (!(used >> pos & 1)) {
          R.gpos[i++] = pos;
          used |= 1u << pos;
          break;
        }
    for (int pos = 0; pos < P.wq; ++pos)
      if (!(used >> pos & 1)) {
        R.gpos[i++] = pos;
        used |= 1u << pos;
      }
    while (i < kGroupBits) R.gpos[i++] = 0;  // bits of g that are 0
  }
  return P;
}

// y, out: (nb, n1, n2) int64; tw1: (S1, n1), twm: (n1, n2), tw2: (S2, n2)
// uint32 words; n1 <= n2 powers of two, n1 >= 1, 2 <= n2 <= kTileWords;
// p < 2^30.
// passes: 1 the first pass, 2 the grid barrier, 4 the second pass (7 is
// the transform; the others time its parts).
extern "C" int onepass_ntt_launch(const void* y, const void* tw1,
                                  const void* twm, const void* tw2, void* out,
                                  int nb, int n1, int n2, int mirror,
                                  unsigned scale, int scaled, unsigned p,
                                  unsigned n_prime, int passes,
                                  void* stream) {
  static int blocks_max[kMaxDevices];  // per device, 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (blocks_max[dev] == 0) {  // co-resident blocks, at most kBlocksPerSm
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onepass_kernel, kThreads,
        (kTileWords + kTileWords / 2 + kTileWords / 64) * sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    blocks_max[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }

  MontParams f{p, n_prime};
  const int S1 = log2i(n1), S2 = log2i(n2);
  Geometry G;
  G.n1 = n1;
  G.n2 = n2;
  G.rows = (long long)nb * n1;
  int tc = kTileWords / n1;  // columns of an axis-0 tile
  if (tc > n2) tc = n2;
  if (tc < 1) tc = 1;
  const int c0 = log2i(tc);
  long long rt = kTileWords / n2;  // rows of an axis-1 tile
  if (rt > (1ll << log2i(G.rows))) rt = 1ll << log2i(G.rows);
  if (rt < 1) rt = 1;
  const int c1 = log2i(rt);
  G.axis0 = pass_geom(S1, c0, true, nb * (n2 >> c0), n2);
  G.axis1 = pass_geom(S2, c1, false, (int)((G.rows + rt - 1) >> c1), n2);
  const int wq = G.axis0.wq > G.axis1.wq ? G.axis0.wq : G.axis1.wq;
  G.tile_words = 1 << wq;
  const size_t smem =
      (G.tile_words + n2 / 2 + n2 / 64) * sizeof(uint32_t);

  const int work = G.axis0.tiles > G.axis1.tiles ? G.axis0.tiles
                                                 : G.axis1.tiles;
  const int blocks = work < blocks_max[dev] ? work : blocks_max[dev];
  const long long* y_ = (const long long*)y;
  const uint32_t* tw1_ = (const uint32_t*)tw1;
  const uint32_t* twm_ = (const uint32_t*)twm;
  const uint32_t* tw2_ = (const uint32_t*)tw2;
  long long* out_ = (long long*)out;
  void* args[] = {&y_, &tw1_, &twm_, &tw2_, &out_, &G, &mirror, &scale,
                  &scaled, &passes, &f};
  err = cudaLaunchCooperativeKernel((const void*)onepass_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
