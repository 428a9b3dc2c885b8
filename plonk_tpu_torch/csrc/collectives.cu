// K8 and K9: the collectives of the sharded prover, for D shards on one card.
//
// Replaces:
//   K8 plonk_tpu/parallel/pallas_collectives.py::_ring_kernel (called through
//      gather_in_body, :111), the ring all-gather over remote DMA;
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
// K8's design: a grid over (destination shard, tile): blockIdx.y is the
// destination, blockIdx.x and the threads stride over its D*chunk bytes in
// the widest unit (16-byte vectors where the chunk size and every address
// allow it, else 8, 4, 2 or 1 bytes).
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

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 4096;
constexpr int kBatch = 4;  // K9: rows of the batch axis a thread moves

struct ShardPtrs {
  const char* src[MAX_SHARDS];
  char* dst[MAX_SHARDS];
};

// K8: dst[d] (D*chunk units) <- the D sources in shard order.
template <typename V>
__global__ void all_gather_kernel(const __grid_constant__ ShardPtrs ptrs,
                                  int D, long long chunk) {
  const int d = blockIdx.y;
  V* dst = reinterpret_cast<V*>(ptrs.dst[d]);
  const long long total = (long long)D * chunk;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int s = (int)(i / chunk);
    dst[i] = reinterpret_cast<const V*>(ptrs.src[s])[i - (long long)s * chunk];
  }
}

template <typename V>
cudaError_t launch_gather(const ShardPtrs& ptrs, int D, long long chunk_bytes,
                          cudaStream_t stream) {
  const long long chunk = chunk_bytes / (long long)sizeof(V);
  long long blocks = ((long long)D * chunk + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS_X) blocks = MAX_BLOCKS_X;
  all_gather_kernel<V><<<dim3((unsigned)blocks, (unsigned)D), THREADS, 0,
                         stream>>>(ptrs, D, chunk);
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
