// K8 and K9: the collectives of the sharded prover, for D shards on one card.
//
// Replaces:
//   K8 plonk_tpu/parallel/pallas_collectives.py::_ring_kernel (called through
//      gather_in_body, :111), the ring all-gather over remote DMA, which
//      plonk_tpu/parallel/dist_scan.py::dist_prefix_prod runs between its
//      local scans and its carries;
//   K9 plonk_tpu/parallel/pallas_collectives.py::_a2a_kernel (called through
//      all_to_all_in_body, :196), the direct all-to-all over remote DMA,
//      with the relayout XLA runs around it (lax.all_to_all(..., tiled=True)).
//
// Computes the function of the TPU kernels, not their hop schedule. Every
// shard has its own source and destination buffer:
//   K8  dst[d][s*chunk .. (s+1)*chunk) = src[s][0 .. chunk) in bytes;
//   K9  shard s's chunk j along the split axis lands in destination j, which
//       holds the D chunks it receives in source order along the concat
//       axis, each in its final layout.
// The TPU kernels forward chunks over a ring (K8) or start D-1 concurrent
// remote copies (K9), each hop paired with a semaphore, because each device
// runs its own grid; here one launch covers all D shards, so the launch
// orders everything and no flag or barrier is needed. The wrapper
// (plonk_tpu_torch/parallel/collectives.py) refuses destinations that
// overlap a source or each other.
//
// Bound on the H100: device memory. Each source byte is read once per
// destination that receives it and each destination byte written once: K9
// moves each word once each way, K8 reads each source D times (from L2
// after the first) and writes D*D chunks. At the prover's sizes K8 moves one
// word per shard and is launch latency only.
//
// K8's generic all-gather: a grid over (chunk tile, source, destination),
// the source and destination from blockIdx.y and blockIdx.z, so no element
// index is divided; the threads stride over the chunk in the widest unit
// (16-byte vectors where the chunk size and every address allow it, else
// 8, 4, 2 or 1 bytes).
//
// K8 on the prover's path: the sharded prefix product in one launch. The
// sharded grand product is a local scan a shard, the all-gather of the D
// shard totals (one word each) and a multiply by the product of the totals
// before the shard. Alone, the all-gather is a launch for D words between
// hundreds of PyTorch launches; on one card the exchange of totals is a
// look-back between thread blocks, so one launch does all three:
//   - one block a shard, its shard index from an atomic ticket (not from
//     blockIdx), so a block only ever waits on blocks that already run;
//   - the block (512 threads) scans its shard in tiles of 8192 words,
//     loaded and stored coalesced through shared memory (a pad word every
//     32, free of bank conflicts both ways): 16 words a thread serially,
//     then a warp scan over __shfl_up_sync, then a scan of the 16 warp
//     totals in shared memory (Montgomery products, canonical);
//   - warp 0 publishes the shard total in a flag word (value, kind and
//     the launch's epoch: one 64-bit store), writes it into slot d of
//     every shard's row of the gathered totals (all_gather's output), and
//     looks back: lane l waits for the flag of shard d-1-l (D <= 16, so one
//     warp covers every shard before this one in one round trip), and the
//     warp folds the aggregates up to the nearest inclusive prefix (shard
//     0 publishes its total as one). The product is the shard's carry (the
//     Montgomery one for shard 0); the block publishes its own inclusive
//     prefix;
//   - every word is multiplied once by its thread's prefix (the carry, the
//     tiles before, the warps and lanes before) and written once, either
//     inclusive or in the grand product's shifted form (word 0 of shard d
//     its carry, word j the scan at j-1).
// A shard longer than a tile is scanned twice: once for its total, once
// with the carry. The ticket and the D flags live in a small buffer a
// (device, stream). The ticket counts launches (its epoch) above the
// blocks of this launch; the block that takes the last ticket moves it to
// the next epoch, and a flag carries the epoch that wrote it, so a reader
// waits for this launch's flag and a flag left by an earlier launch never
// needs clearing: the buffer is ready for the next launch with no reset
// and no fence (a flag's value travels in its own word). Epochs compare
// in 31 bits: a stale flag could pass only if no launch had written it
// for a multiple of 2^31 launches. Bound:
// bytes (each word read and written once, two products a word); at the
// prover's 8 x 8192 words it is the latency of its dependent steps
// (ticket, loads, scans, look-back, stores), as the all-gather alone was
// launch latency: 1 x 1 word takes 80 % of 8 x 8192's time, and 1024 or
// 256 threads a block time within 3 % of 512.
//
// K9's design. On one card the relayout and the exchange are one copy, so
// the wrapper turns (shard shape, split axis, concat axis, D) into a host
// plan and one launch reads every source word once, from the shard tensors
// as they are, and writes every destination word once, into its final
// layout. The plan: for each pair (source s, destination j) the same block
// of nb x nr rows of `run` contiguous units, at source offset j * src_pair
// + b * sb + r * sr and destination offset s * dst_pair + b * db + r * dr
// (the block's axes merged wherever both layouts are contiguous across
// them; at most three remain). The grid is (row tiles x run segments, batch
// groups, D * D pairs): the pair, the row and the unit come from the grid
// and the thread index, with no division per element; neighbouring threads
// copy neighbouring units of a run in the widest unit the run, the strides
// and the addresses allow (16 bytes at the prover's runs of 32 and 64
// words), and each thread loads up to kBatch rows before it stores them.
// The D pointer pairs and the plan travel in a kernel-parameter struct
// (D <= 16), read in place (__grid_constant__).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "mont.cuh"

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 4096;
constexpr int kBatch = 4;  // K9: rows of the batch axis a thread moves

struct ShardPtrs {
  const char* src[MAX_SHARDS];
  char* dst[MAX_SHARDS];
};

// K8: slot s of dst[d] (chunk units) <- src[s]; blockIdx.y is the source,
// blockIdx.z the destination.
template <typename V>
__global__ void __launch_bounds__(THREADS)
    all_gather_kernel(const __grid_constant__ ShardPtrs ptrs,
                      long long chunk) {
  const V* src = reinterpret_cast<const V*>(ptrs.src[blockIdx.y]);
  V* dst = reinterpret_cast<V*>(ptrs.dst[blockIdx.z]) + blockIdx.y * chunk;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < chunk; i += step)
    dst[i] = src[i];
}

template <typename V>
cudaError_t launch_gather(const ShardPtrs& ptrs, int D, long long chunk_bytes,
                          cudaStream_t stream) {
  const long long chunk = chunk_bytes / (long long)sizeof(V);
  long long blocks = (chunk + THREADS - 1) / THREADS;
  const long long cap = MAX_BLOCKS_X / (D * D) > 0 ? MAX_BLOCKS_X / (D * D)
                                                   : 1;
  if (blocks > cap) blocks = cap;
  all_gather_kernel<V><<<dim3((unsigned)blocks, (unsigned)D, (unsigned)D),
                         THREADS, 0, stream>>>(ptrs, chunk);
  return cudaGetLastError();
}

// K9's plan, every length, stride and offset in copy units.
struct A2aPlan {
  ShardPtrs ptrs;
  long long nb, nr, run;         // batch rows, rows, units a row
  long long sb, sr, db, dr;      // batch and row strides: source, destination
  long long src_pair, dst_pair;  // chunk j of a source, slot s of a dest
  int D;
  int tx_bits;  // the threads of a row segment: 2^tx_bits
  int nseg;     // segments of 2^tx_bits units a row
};

template <typename V>
__global__ void __launch_bounds__(THREADS)
    all_to_all_kernel(const __grid_constant__ A2aPlan P) {
  const int s = blockIdx.z / P.D;      // source shard
  const int j = blockIdx.z - s * P.D;  // destination shard
  const int tile = blockIdx.x / P.nseg;
  const int seg = blockIdx.x - tile * P.nseg;
  const long long u = ((long long)seg << P.tx_bits) +
                      (threadIdx.x & ((1u << P.tx_bits) - 1));
  const long long r =
      ((long long)tile << (8 - P.tx_bits)) + (threadIdx.x >> P.tx_bits);
  if (u >= P.run || r >= P.nr) return;
  const V* src = reinterpret_cast<const V*>(P.ptrs.src[s]) + j * P.src_pair +
                 r * P.sr + u;
  V* dst = reinterpret_cast<V*>(P.ptrs.dst[j]) + s * P.dst_pair + r * P.dr +
           u;
  for (long long b0 = (long long)blockIdx.y * kBatch; b0 < P.nb;
       b0 += (long long)gridDim.y * kBatch) {
    V v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (b0 + k < P.nb) v[k] = src[(b0 + k) * P.sb];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (b0 + k < P.nb) dst[(b0 + k) * P.db] = v[k];
  }
}

template <typename V>
cudaError_t launch_a2a(A2aPlan& P, cudaStream_t stream) {
  static_assert(THREADS == 256, "the kernel splits 8 thread-index bits");
  int tx_bits = 0;
  while (tx_bits < 8 && (1ll << tx_bits) < P.run) ++tx_bits;
  P.tx_bits = tx_bits;
  P.nseg = (int)((P.run + (1ll << tx_bits) - 1) >> tx_bits);
  const int rows = THREADS >> tx_bits;  // rows a block
  const long long gx = (P.nr + rows - 1) / rows * P.nseg;
  long long gy = (P.nb + kBatch - 1) / kBatch;
  if (gy > 65535) gy = 65535;
  if (gx > INT_MAX || P.run > INT_MAX) return cudaErrorInvalidValue;
  all_to_all_kernel<V><<<dim3((unsigned)gx, (unsigned)gy,
                              (unsigned)(P.D * P.D)),
                         THREADS, 0, stream>>>(P);
  return cudaGetLastError();
}

bool load_ptrs(ShardPtrs& ptrs, const void* const* srcs, void* const* dsts,
               int D) {
  if (D < 1 || D > MAX_SHARDS) return false;
  for (int s = 0; s < D; ++s) {
    ptrs.src[s] = static_cast<const char*>(srcs[s]);
    ptrs.dst[s] = static_cast<char*>(dsts[s]);
  }
  return true;
}

// ---- K8 on the prover's path: the sharded prefix product ----

constexpr int SCAN_THREADS = 512;
constexpr int SCAN_ITEMS = 16;  // words a thread scans serially
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
static_assert(SCAN_WARPS <= 32, "one warp scans the warp totals");
static_assert(MAX_SHARDS <= 32, "one warp reads every predecessor's flag");
// The state buffer: [0] the ticket, the launch's epoch above its low byte
// and the blocks that took one in it; [1, 1 + D) the shards' flags. A flag
// word: the value (< p < 2^31) in bits 0-30, its kind in bits 31-32, the
// low 31 bits of the epoch that wrote it above.
constexpr int TICKET_BITS = 8;  // > log2(MAX_SHARDS)
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 31;  // shard total
constexpr unsigned long long FLAG_PREFIX = 2ull << 31;     // inclusive prefix
constexpr int EPOCH_SHIFT = 33;

struct ScanArgs {
  const long long* src[MAX_SHARDS];
  long long* dst[MAX_SHARDS];
  long long* totals;  // D x D: row e, slot d holds shard d's total
  unsigned long long* state;
  long long m;  // words a shard
  int D;
  int shifted;
  MontParams f;
  uint32_t one;  // the Montgomery one, R mod p
};

// A flag carries its value in its own word, so a flag is published and
// read with strong relaxed accesses at the device scope: no fence orders
// other data with it.
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A tile word's place in shared memory: one pad word every 32, so that
// both a thread's SCAN_ITEMS consecutive words and a warp's 32 consecutive
// words fall in 32 different banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// The inclusive scan of the tile at `base` (words past m count as the one),
// loaded coalesced through shared memory: v holds this thread's SCAN_ITEMS
// words scanned serially, excl the product of the tile's words before
// them; returns the tile's product.
__device__ __forceinline__ uint32_t scan_tile(const long long* src,
                                              long long base, long long m,
                                              uint32_t (&v)[SCAN_ITEMS],
                                              uint32_t& excl, MontParams f,
                                              uint32_t one, uint32_t* tile,
                                              uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + threadIdx.x;
    tile[padded(i)] = base + i < m ? (uint32_t)src[base + i] : one;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k)
    v[k] = tile[padded(threadIdx.x * SCAN_ITEMS + k)];
#pragma unroll
  for (int k = 1; k < SCAN_ITEMS; ++k) v[k] = mont_mul(v[k - 1], v[k], f);
  uint32_t x = v[SCAN_ITEMS - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = mont_mul(y, x, f);
  }
  uint32_t lane_excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) lane_excl = one;
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    uint32_t s = lane < SCAN_WARPS ? warp_tot[lane] : one;
#pragma unroll
    for (int off = 1; off < SCAN_WARPS; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = mont_mul(y, s, f);
    }
    if (lane < SCAN_WARPS) warp_tot[lane] = s;
  }
  __syncthreads();
  const uint32_t total = warp_tot[SCAN_WARPS - 1];
  excl = w ? mont_mul(warp_tot[w - 1], lane_excl, f) : lane_excl;
  __syncthreads();  // warp_tot and tile are reused
  return total;
}

// This thread's words of the tile at `base`, times `pre` (the product of
// every word of the shard's sequence before them, carry included): the
// inclusive scan, or shifted by one word; stored coalesced through shared
// memory.
__device__ __forceinline__ void store_tile(long long* dst, long long base,
                                           long long m,
                                           const uint32_t (&v)[SCAN_ITEMS],
                                           uint32_t pre, int shifted,
                                           MontParams f, uint32_t* tile) {
  const int t0 = threadIdx.x * SCAN_ITEMS;
  if (shifted) {
    tile[padded(t0)] = pre;
#pragma unroll
    for (int k = 1; k < SCAN_ITEMS; ++k)
      tile[padded(t0 + k)] = mont_mul(pre, v[k - 1], f);
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      tile[padded(t0 + k)] = mont_mul(pre, v[k], f);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCAN_THREADS + threadIdx.x;
    if (base + i < m) dst[base + i] = tile[padded(i)];
  }
  __syncthreads();  // tile is reused
}

__global__ void __launch_bounds__(SCAN_THREADS)
    prefix_scan_kernel(const __grid_constant__ ScanArgs A) {
  __shared__ uint32_t tile[SCAN_TILE + SCAN_TILE / 32];
  __shared__ uint32_t warp_tot[SCAN_WARPS];
  __shared__ unsigned long long ticket_sh;
  __shared__ uint32_t carry_sh;
  unsigned long long* ticket = A.state;
  unsigned long long* flags = A.state + 1;
  const MontParams f = A.f;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(ticket, 1ull);
    // the last block of the launch moves the ticket to the next epoch
    if ((int)(t & ((1u << TICKET_BITS) - 1)) == A.D - 1)
      atomicAdd(ticket, (1ull << TICKET_BITS) - A.D);
    ticket_sh = t;
  }
  __syncthreads();
  const int d = (int)(ticket_sh & ((1u << TICKET_BITS) - 1));
  const unsigned long long epoch = (ticket_sh >> TICKET_BITS)
                                   << EPOCH_SHIFT;  // bits above 63 drop
  const long long* src = A.src[d];
  uint32_t v[SCAN_ITEMS], excl;
  const uint32_t first =
      scan_tile(src, 0, A.m, v, excl, f, A.one, tile, warp_tot);
  uint32_t total = first;
  for (long long base = SCAN_TILE; base < A.m; base += SCAN_TILE) {
    uint32_t u[SCAN_ITEMS], e;
    total = mont_mul(total, scan_tile(src, base, A.m, u, e, f, A.one, tile,
                                      warp_tot), f);
  }
  if (threadIdx.x < 32) {
    // warp 0: publish the total, gather it, look back over every shard
    // before this one at once (lane l reads shard d - 1 - l's flag, and
    // waits for this epoch's)
    const int lane = threadIdx.x;
    if (lane == 0)
      store_relaxed(flags + d,
                    epoch | (d ? FLAG_AGGREGATE : FLAG_PREFIX) | total);
    for (int e = lane; e < A.D; e += 32)
      A.totals[(long long)e * A.D + d] = total;
    const int j = d - 1 - lane;
    unsigned long long fl = 0;
    if (j >= 0) {
      do {
        fl = load_relaxed(flags + j);
      } while ((fl & (~0ull << EPOCH_SHIFT)) != epoch ||
               !(fl & (FLAG_AGGREGATE | FLAG_PREFIX)));
    }
    // fold the aggregates up to the nearest inclusive prefix (shard 0's
    // flag always is one, so a lane finds one whenever d > 0)
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, (fl & FLAG_PREFIX) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : -1;
    uint32_t carry = lane <= stop ? (uint32_t)fl & 0x7fffffffu : A.one;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      carry = mont_mul(carry, __shfl_xor_sync(0xffffffffu, carry, off), f);
    if (lane == 0) {
      if (d)
        store_relaxed(flags + d,
                      epoch | FLAG_PREFIX | mont_mul(carry, total, f));
      carry_sh = carry;
    }
  }
  __syncthreads();
  long long* dst = A.dst[d];
  uint32_t run = carry_sh, tile_total = first;
  for (long long base = 0; base < A.m; base += SCAN_TILE) {
    if (base)
      tile_total =
          scan_tile(src, base, A.m, v, excl, f, A.one, tile, warp_tot);
    store_tile(dst, base, A.m, v, mont_mul(run, excl, f), A.shifted, f,
               tile);
    run = mont_mul(run, tile_total, f);
  }
}

}  // namespace

// srcs: D pointers to chunk_bytes each; dsts: D pointers to D*chunk_bytes
// each. unit: the copy width in bytes (16, 8, 4, 2 or 1), dividing
// chunk_bytes and every address.
extern "C" int all_gather_launch(const void* const* srcs, void* const* dsts,
                                 int D, long long chunk_bytes, int unit,
                                 void* stream) {
  ShardPtrs ptrs{};
  if (!load_ptrs(ptrs, srcs, dsts, D) || chunk_bytes <= 0 || unit <= 0 ||
      chunk_bytes % unit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return (int)launch_gather<uint4>(ptrs, D, chunk_bytes, st);
    case 8: return (int)launch_gather<uint2>(ptrs, D, chunk_bytes, st);
    case 4: return (int)launch_gather<uint32_t>(ptrs, D, chunk_bytes, st);
    case 2: return (int)launch_gather<uint16_t>(ptrs, D, chunk_bytes, st);
    case 1: return (int)launch_gather<uint8_t>(ptrs, D, chunk_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// srcs, dsts: the D shards' pointers; the plan's lengths nb, nr, run >= 1
// (run in units), its strides and pair offsets in units; unit: the copy
// width in bytes (16, 8, 4, 2 or 1), dividing every address.
extern "C" int all_to_all_launch(const void* const* srcs, void* const* dsts,
                                 int D, long long nb, long long nr,
                                 long long run, long long sb, long long sr,
                                 long long db, long long dr,
                                 long long src_pair, long long dst_pair,
                                 int unit, void* stream) {
  A2aPlan P{};
  if (!load_ptrs(P.ptrs, srcs, dsts, D) || nb < 1 || nr < 1 || run < 1)
    return (int)cudaErrorInvalidValue;
  P.nb = nb;
  P.nr = nr;
  P.run = run;
  P.sb = sb;
  P.sr = sr;
  P.db = db;
  P.dr = dr;
  P.src_pair = src_pair;
  P.dst_pair = dst_pair;
  P.D = D;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return (int)launch_a2a<uint4>(P, st);
    case 8: return (int)launch_a2a<uint2>(P, st);
    case 4: return (int)launch_a2a<uint32_t>(P, st);
    case 2: return (int)launch_a2a<uint16_t>(P, st);
    case 1: return (int)launch_a2a<uint8_t>(P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// srcs, dsts: the D shards' pointers, m int64 words each, in Montgomery
// form in [0, p); totals: D x D int64 words; state: 1 + MAX_SHARDS uint64
// words, zero before the first launch on a stream and left by each launch
// ready for the next one (no launches on other streams share it);
// shifted: write the grand product's shifted form; one: R mod p.
extern "C" int prefix_scan_launch(const void* const* srcs, void* const* dsts,
                                  void* totals, void* state, int D,
                                  long long m, int shifted, unsigned p,
                                  unsigned n_prime, unsigned one,
                                  void* stream) {
  ScanArgs A{};
  if (D < 1 || D > MAX_SHARDS || m < 1) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < D; ++s) {
    A.src[s] = static_cast<const long long*>(srcs[s]);
    A.dst[s] = static_cast<long long*>(dsts[s]);
  }
  A.totals = static_cast<long long*>(totals);
  A.state = static_cast<unsigned long long*>(state);
  A.m = m;
  A.D = D;
  A.shifted = shifted;
  A.f = MontParams{p, n_prime};
  A.one = one;
  prefix_scan_kernel<<<D, SCAN_THREADS, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
