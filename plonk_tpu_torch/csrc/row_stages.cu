// K1 and K5: butterfly stages along the rows of a (R, C) array, one pass.
//
// Replaces:
//   K1 plonk_tpu/ops/pallas_ntt.py::_row_stages_kernel (called through
//      row_stages from plonk_tpu/ops/ntt.py:153-160), the intra-row stages
//      of the blocked NTT;
//   K5 plonk_tpu/ops/pallas_ntt.py::_full_row_kernel (called through
//      row_transform, :188, from plonk_tpu/ops/fused_ntt.py::_row_pass),
//      one complete size-C transform per row, the row passes of the
//      five-step fused_ntt / fused_intt.
//
// Computes, for each C-wide row of a (R, C) array of Montgomery words, all
// log2(C) radix-2 stages, as the TPU kernels do. DIT (K1, and K5's
// bit-reversed -> natural direction): stages half = 1 .. C/2; at stage s
// (half = 2^s) the low lane j of a pair becomes y[j] + y[j+half] * tw[s][j]
// and the high lane j+half becomes y[j] - y[j+half] * tw[s][j+half]. DIF
// (K5's natural -> bit-reversed direction): stages half = C/2 .. 1, the pair
// (a, b) = (y[lo], y[lo+half]) becomes (a + b, (a - b) * tw[s][lo+half]).
// The wrappers accept only lane-periodic tables, tw[s][j] == tw[s][j mod
// 2^s] (every table ops/ntt.py and ops/fused_ntt.py make), so both lanes of
// a pair share one twiddle and one Montgomery product: the kernel reads the
// compact table of C - 1 words, stage s's 2^s distinct values at offset
// 2^s - 1.
//
// Bound on the H100: device memory. Each row is read once and written once
// (4 bytes of value per 31-bit word; the port's int64 I/O moves 8, a floor
// above the values' bound); the log2(C) stages in between cost C/2
// Montgomery products per stage and row, below the card's integer rate.
//
// Design. The TPU kernels ran one stage at a time over lane vectors. Here a
// block of 256 threads takes tiles of 2048 words (2048 / C whole rows) and
// walks them grid-stride, with the grid at the SM count times the resident
// blocks (at most 8 an SM), so that any row count fills the card in one
// wave; a block with several tiles loads the next one's words while it
// transforms the current one. A tile's positions q are bits: the element
// index at bits [0, S), the row in the tile above. The stages run in
// radix-8 register rounds: thread g holds the 8 positions of group g that
// differ in three q bits and runs the three stages of those bits on its
// registers; the tile goes through shared memory between rounds (4 rounds
// and 3 barriers at C = 1024 instead of 10 barriers; S mod 3 stages take a
// shorter round, the lowest, whose spare register bits take the next q
// bits). DIT runs the rounds from the lowest element bits up, DIF the same
// rounds from the top down, each round's stages in reverse order, so both
// directions share one geometry. S and the direction are template
// parameters, so each round's stage bits and shifts are constants; the host
// fixes each round's positions and passes them in the launch's
// __grid_constant__ geometry. The lowest round's 8 words are neighbours,
// loaded with 16-byte loads (DIT). Words stay below 2p
// between stages (Harvey's lazy butterflies, for p < 2^30: DIT
// (a + u, a - u + 2p) with u = b * tw below 2p, DIF (a + b, (a - b + 2p) *
// tw), sums folded below 2p) and become canonical at the store. DIF ends
// in the lowest round, where a thread holds 8 neighbours and a warp 256
// consecutive words: the warp passes them through its own part of the
// shared tile, so that each store instruction writes 512 contiguous bytes
// (16-byte stores straight from the registers, 64 bytes apart across the
// warp, made DIF the slower direction). The
// compact table is copied to shared memory once per block, and a round
// reads the 7 distinct twiddles of its 12 butterflies. Shared memory is
// swizzled (q ^ (q >> 5) & 31) and the group index is spread over q bits of
// distinct residues mod 5 (in the lowest round over q bits 3-7 in order),
// so that a warp's 32 accesses hit 32 banks in every round; 5 blocks an
// SM fit the register budget, for one wave at the 2^18 path's 640 tiles
// (a DIF instance left at 62 registers ran 4 an SM, and slower). The
// SM count and the occupancy are queried once per device,
// width and direction.
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

constexpr int kThreads = 256;
constexpr int kTileBits = 11;
constexpr int kTileWords = 1 << kTileBits;  // 8 a thread
constexpr int kBlocksPerSm = 8;             // blocks launched an SM, at most
// blocks an SM that the register budget must allow (48 registers a
// thread): 660 blocks hold the 640 tiles of 1.31 M words in one wave
constexpr int kMinBlocksPerSm = 5;
constexpr int kMaxDevices = 64;
constexpr int kMaxRounds = 4;               // ceil(log2(1024) / 3)
constexpr int kGroupBits = 8;               // log2(kThreads)

// The tile positions of a round, fixed by the host: register k of group g
// holds position base | qoff[k], where base puts bit i of g on q bit
// gpos[i]. The low five bits of g go to q bits of distinct residues mod 5,
// which the shared-memory swizzle turns into distinct banks.
struct RoundPlan {
  uint32_t qoff[8];     // tile position of register k (base = 0)
  uint32_t soff[8];     // its shared-memory word, swz(qoff[k])
  int gpos[kGroupBits];
};

// plan[r]: the round of element bits glo .. glo + b - 1, lowest first (the
// kernel's kFirst and glo)
struct Geometry {
  RoundPlan plan[kMaxRounds];
};

__host__ __device__ __forceinline__ uint32_t swz(uint32_t q) {
  return q ^ ((q >> 5) & 31);
}

// The tile position of register 0 for group index g.
__device__ __forceinline__ uint32_t group_base(const RoundPlan& R,
                                               uint32_t g) {
  uint32_t base = 0;
#pragma unroll
  for (int i = 0; i < kGroupBits; ++i) base |= (g >> i & 1u) << R.gpos[i];
  return base;
}

// a mod m for a < 2m.
__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t m) {
  return min(a, a - m);
}

// a * b / 2^32 mod p, below 2p for a < 4p and b < p (no final
// subtraction): (4p * p + 2^32 p) / 2^32 < 2p when 4p < 2^32.
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t b,
                                             MontParams f) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * f.n_prime;
  return (uint32_t)((t + (uint64_t)m * f.p) >> 32);
}

// The B DIT stages of a round on registers v (register bit e holds element
// bit glo + e, e < B): one lazy product per butterfly, the lane twiddle of
// stage s at lane j read from tw[2^s - 1 + (j mod 2^s)]. ebase is the
// element index of register 0; stage e's twiddle depends only on the
// element bits below it, so 2^e reads serve its 4 butterflies.
template <int B>
__device__ __forceinline__ void dit_round(uint32_t (&v)[8],
                                          const uint32_t* tw, int glo,
                                          uint32_t ebase, MontParams f) {
  const uint32_t p2 = f.p << 1;
#pragma unroll
  for (int e = 0; e < B; ++e) {
    const int s = glo + e;
    const uint32_t mask = (1u << s) - 1;
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < (1 << e); ++m)
      w[m] = tw[mask + ((ebase | ((uint32_t)m << glo)) & mask)];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k & (1 << e)) continue;
      const int h = k | (1 << e);
      const uint32_t u = mul_lazy(v[h], w[k & ((1 << e) - 1)], f);
      v[h] = csub(v[k] - u + p2, p2);
      v[k] = csub(v[k] + u, p2);
    }
  }
}

// The B DIF stages of a round on registers v, the highest first (the
// Gentleman-Sande butterfly): a' = a + b, b' = (a - b) * tw, both below 2p
// for a, b below 2p; the twiddles as in dit_round (tw[s][lo + half] ==
// tw[s][lo] for a lane-periodic table).
template <int B>
__device__ __forceinline__ void dif_round(uint32_t (&v)[8],
                                          const uint32_t* tw, int glo,
                                          uint32_t ebase, MontParams f) {
  const uint32_t p2 = f.p << 1;
#pragma unroll
  for (int e = B - 1; e >= 0; --e) {
    const int s = glo + e;
    const uint32_t mask = (1u << s) - 1;
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < (1 << e); ++m)
      w[m] = tw[mask + ((ebase | ((uint32_t)m << glo)) & mask)];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k & (1 << e)) continue;
      const int h = k | (1 << e);
      const uint32_t a = v[k], b = v[h];
      v[k] = csub(a + b, p2);
      v[h] = mul_lazy(a - b + p2, w[k & ((1 << e) - 1)], f);
    }
  }
}

// v[k] = the word at position base | P.qoff[k] of tile `tile` (0 past the
// rows), pairs of neighbours in one 16-byte load when vec; returns how many
// of the tile's positions hold words.
__device__ __forceinline__ uint32_t load_tile(uint32_t (&v)[8],
                                              const long long* y,
                                              long long tile, long long R,
                                              int S, int rbits,
                                              const RoundPlan& P,
                                              uint32_t base, bool vec) {
  const long long left = R - (tile << rbits);
  const uint32_t valid =
      left >= (1ll << rbits) ? kTileWords : (uint32_t)left << S;
  const long long* src = y + ((size_t)tile << kTileBits);
  if (vec) {
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const uint32_t q = base | P.qoff[k];
      longlong2 x = make_longlong2(0, 0);
      if (q < valid) x = *reinterpret_cast<const longlong2*>(src + q);
      v[k] = (uint32_t)x.x;
      v[k + 1] = (uint32_t)x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t q = base | P.qoff[k];
      v[k] = q < valid ? (uint32_t)src[q] : 0u;
    }
  }
  return valid;
}

// S and the direction are template parameters, so that each round's stage
// bits, and with them every shift of the butterflies and twiddle indices,
// are constants.
template <int S, bool DIF>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    row_stages_kernel(const long long* __restrict__ y,
                      const uint32_t* __restrict__ tw,
                      long long* __restrict__ out, long long R,
                      const __grid_constant__ Geometry G, MontParams f) {
  constexpr int C = 1 << S;
  constexpr int kRowBits = kTileBits - S;
  constexpr int kRounds = (S + 2) / 3;
  constexpr int kFirst = S - 3 * (kRounds - 1);  // stage bits of round 0
  __shared__ uint32_t sm[kTileWords];
  __shared__ uint32_t tws[C];  // C - 1 words used
  const long long tiles = (R + (1ll << kRowBits) - 1) >> kRowBits;
  const uint32_t g = threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // the round that loads the tile and the one that stores it
  const RoundPlan& PI = G.plan[DIF ? kRounds - 1 : 0];
  const RoundPlan& PO = G.plan[DIF ? 0 : kRounds - 1];
  const uint32_t baseI = group_base(PI, g);
  const uint32_t baseO = group_base(PO, g);
  const bool vecI = vec && PI.qoff[1] == 1;
  const bool vecO = vec && PO.qoff[1] == 1;

  // the first tile's words go out before the twiddles are copied, and
  // each next tile's before the current one is transformed
  uint32_t next[8];
  long long tile = blockIdx.x;
  uint32_t next_valid = 0;
  if (tile < tiles)
    next_valid = load_tile(next, y, tile, R, S, kRowBits, PI, baseI, vecI);
  for (int i = threadIdx.x; i < C - 1; i += kThreads) tws[i] = __ldg(tw + i);
  __syncthreads();

  for (; tile < tiles; tile += gridDim.x) {
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = next[k];
    const uint32_t valid = next_valid;  // positions q < valid hold words
    if (tile + gridDim.x < tiles)
      next_valid = load_tile(next, y, tile + gridDim.x, R, S, kRowBits, PI,
                             baseI, vecI);
    long long* dst = out + ((size_t)tile << kTileBits);
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int r = DIF ? kRounds - 1 - i : i;
      const RoundPlan& P = G.plan[r];
      const bool last = i == kRounds - 1;
      const int b = r == 0 ? kFirst : 3;
      const int glo = r == 0 ? 0 : kFirst + 3 * (r - 1);
      const uint32_t base =
          i == 0 ? baseI : (last ? baseO : group_base(P, g));
      const uint32_t sbase = swz(base);
      if (i > 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = sm[sbase ^ P.soff[k]];
      }
      const uint32_t ebase = base & (C - 1);
      if (DIF) {
        if (b == 1)
          dif_round<1>(v, tws, glo, ebase, f);
        else if (b == 2)
          dif_round<2>(v, tws, glo, ebase, f);
        else
          dif_round<3>(v, tws, glo, ebase, f);
      } else {
        if (b == 1)
          dit_round<1>(v, tws, glo, ebase, f);
        else if (b == 2)
          dit_round<2>(v, tws, glo, ebase, f);
        else
          dit_round<3>(v, tws, glo, ebase, f);
      }
      if (last && DIF) {
        // round 0 gives warp w the 256 positions from 256 w, 8 neighbours
        // a thread: they go through the warp's own part of the tile, so
        // that each store writes 32 pairs of neighbours, 512 bytes in a row
#pragma unroll
        for (int k = 0; k < 8; ++k) sm[sbase ^ P.soff[k]] = csub(v[k], f.p);
        __syncwarp();
        const uint32_t lane = g & 31;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t q = (g >> 5 << 8) | (j << 6) | (lane << 1);
          const long long w0 = sm[swz(q)], w1 = sm[swz(q + 1)];
          if (q >= valid) continue;
          if (vec) {
            *reinterpret_cast<longlong2*>(dst + q) = make_longlong2(w0, w1);
          } else {
            dst[q] = w0;
            dst[q + 1] = w1;
          }
        }
      } else if (last) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = csub(v[k], f.p);
        if (vecO) {
#pragma unroll
          for (int k = 0; k < 8; k += 2)
            if ((baseO | PO.qoff[k]) < valid)
              *reinterpret_cast<longlong2*>(dst + (baseO | PO.qoff[k])) =
                  make_longlong2((long long)v[k], (long long)v[k + 1]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if ((baseO | PO.qoff[k]) < valid)
              dst[baseO | PO.qoff[k]] = (long long)v[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) sm[sbase ^ P.soff[k]] = v[k];
      }
      __syncthreads();  // the next round (or tile) reads what this wrote
    }
  }
}

// The rounds of S stages on a tile of kTileBits q bits: 3 stage bits each
// from the top, S mod 3 (or 3) at the bottom; a shorter first round's spare
// register bits take the lowest free q bits. Round 0's registers are then q
// bits 0-2, and its group bits the rest in order, so that warp w holds the
// 256 positions from 256 w (its DIF store transposes them); the others
// spread their low five group bits over q bits of distinct residues mod 5.
static Geometry row_geom(int S) {
  Geometry G;
  const int rounds = (S + 2) / 3;
  const int b0 = S - 3 * (rounds - 1);
  for (int grp = 0; grp < rounds; ++grp) {
    RoundPlan& R = G.plan[grp];
    const int b = grp == 0 ? b0 : 3;
    const int glo = grp == 0 ? 0 : b0 + 3 * (grp - 1);
    uint32_t used = 0;
    int qpos[3];
    for (int e = 0; e < 3; ++e) {
      qpos[e] = glo + e;
      if (e >= b) {  // a spare register bit: the lowest free q bit
        qpos[e] = 0;
        while ((used >> qpos[e] & 1) || (qpos[e] >= glo && qpos[e] < glo + b))
          ++qpos[e];
      }
      used |= 1u << qpos[e];
    }
    for (int k = 0; k < 8; ++k) {
      R.qoff[k] = ((k & 1u) << qpos[0]) | ((k >> 1 & 1u) << qpos[1]) |
                  ((k >> 2 & 1u) << qpos[2]);
      R.soff[k] = swz(R.qoff[k]);
    }
    int i = 0;
    for (int r = 0; r < 5 && grp > 0; ++r)
      for (int pos = r; pos < 10; pos += 5)
        if (!(used >> pos & 1)) {
          R.gpos[i++] = pos;
          used |= 1u << pos;
          break;
        }
    for (int pos = 0; pos < kTileBits; ++pos)
      if (!(used >> pos & 1)) {
        R.gpos[i++] = pos;
        used |= 1u << pos;
      }
  }
  return G;
}

// One launch of row_stages_kernel<S, DIF> on R rows.
template <int S, bool DIF>
static cudaError_t launch(const long long* y, const uint32_t* tw,
                          long long* out, long long R, MontParams f,
                          cudaStream_t stream) {
  static int blocks_max[kMaxDevices];  // per device, 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (blocks_max[dev] == 0) {  // resident blocks, at most kBlocksPerSm
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_stages_kernel<S, DIF>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks_max[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  const Geometry G = row_geom(S);
  const long long tiles =
      (R + (1ll << (kTileBits - S)) - 1) >> (kTileBits - S);
  const int blocks =
      tiles < blocks_max[dev] ? (int)tiles : blocks_max[dev];
  row_stages_kernel<S, DIF>
      <<<blocks, kThreads, 0, stream>>>(y, tw, out, R, G, f);
  return cudaGetLastError();
}

template <bool DIF>
static cudaError_t launch_width(const long long* y, const uint32_t* tw,
                                long long* out, long long R, int S,
                                MontParams f, cudaStream_t st) {
  switch (S) {
    case 1: return launch<1, DIF>(y, tw, out, R, f, st);
    case 2: return launch<2, DIF>(y, tw, out, R, f, st);
    case 3: return launch<3, DIF>(y, tw, out, R, f, st);
    case 4: return launch<4, DIF>(y, tw, out, R, f, st);
    case 5: return launch<5, DIF>(y, tw, out, R, f, st);
    case 6: return launch<6, DIF>(y, tw, out, R, f, st);
    case 7: return launch<7, DIF>(y, tw, out, R, f, st);
    case 8: return launch<8, DIF>(y, tw, out, R, f, st);
    case 9: return launch<9, DIF>(y, tw, out, R, f, st);
    case 10: return launch<10, DIF>(y, tw, out, R, f, st);
    default: return cudaErrorInvalidValue;
  }
}

// y, out: (R, C) int64; tw: the C - 1 uint32 words of the compact table;
// C = 2^S, 1 <= S <= 10; dif: 0 for the DIT stages (K1, K5's bit-reversed
// -> natural), 1 for DIF (K5's natural -> bit-reversed); p < 2^30.
extern "C" int row_stages_launch(const void* y, const void* tw, void* out,
                                 long long R, int S, int dif, unsigned p,
                                 unsigned n_prime, void* stream) {
  const long long* y_ = (const long long*)y;
  const uint32_t* tw_ = (const uint32_t*)tw;
  long long* out_ = (long long*)out;
  const MontParams f{p, n_prime};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dif ? launch_width<true>(y_, tw_, out_, R, S, f, st)
                   : launch_width<false>(y_, tw_, out_, R, S, f, st));
}
