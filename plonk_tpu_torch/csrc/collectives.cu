// K8 and K9: the collectives of the sharded prover, for D shards on one card.
//
// Replaces:
//   K8 plonk_tpu/parallel/pallas_collectives.py::_ring_kernel (called through
//      gather_in_body, :111), the ring all-gather over remote DMA;
//   K9 plonk_tpu/parallel/pallas_collectives.py::_a2a_kernel (called through
//      all_to_all_in_body, :196), the direct all-to-all over remote DMA.
//
// Computes the function of the TPU kernels, not their hop schedule. Every
// shard has its own source and destination buffer; for destination shard d
// and source shard s,
//   K8  dst[d][s*chunk .. (s+1)*chunk) = src[s][0 .. chunk)
//   K9  dst[d][s*chunk .. (s+1)*chunk) = src[s][d*chunk .. (d+1)*chunk)
// in bytes, whatever the element type. The TPU kernels forward chunks over
// a ring (K8) or start D-1 concurrent remote copies (K9), each hop paired
// with a semaphore, because each device runs its own grid; here one launch
// covers all D shards, so the launch orders everything and no flag or
// barrier is needed. The wrapper (plonk_tpu_torch/parallel/collectives.py)
// refuses destinations that overlap a source or each other.
//
// Bound on the H100: device memory. Each source byte is read once per
// destination that receives it and each destination byte written once: K9
// moves its D*D chunks once each way, K8 reads each source D times (from
// L2 after the first) and writes D*D chunks. At the prover's sizes K8 moves
// one word per shard and is launch latency only.
// Design: a grid over (destination shard, tile): blockIdx.y is the
// destination, blockIdx.x and the threads stride over its D*chunk bytes in
// the widest unit (16-byte vectors where the chunk size and every address
// allow it, else 8, 4, 2 or 1 bytes) so neighbouring threads copy
// neighbouring addresses. The D source and destination pointers travel in
// a kernel-parameter struct (D <= 16), read in place (__grid_constant__).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 4096;

struct ShardPtrs {
  const char* src[MAX_SHARDS];
  char* dst[MAX_SHARDS];
};

// dst[d] (D*chunk units) <- the D sources, source s read from unit
// d*src_stride on; src_stride = chunk for K9, 0 for K8.
template <typename V>
__global__ void exchange_kernel(const __grid_constant__ ShardPtrs ptrs,
                                int D, long long chunk,
                                long long src_stride) {
  const int d = blockIdx.y;
  V* dst = reinterpret_cast<V*>(ptrs.dst[d]);
  const long long total = (long long)D * chunk;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int s = (int)(i / chunk);
    const long long k = i - (long long)s * chunk;
    const V* src = reinterpret_cast<const V*>(ptrs.src[s]);
    dst[i] = src[(long long)d * src_stride + k];
  }
}

template <typename V>
cudaError_t launch(const ShardPtrs& ptrs, int D, long long chunk_bytes,
                   bool all_to_all, cudaStream_t stream) {
  const long long chunk = chunk_bytes / (long long)sizeof(V);
  const long long total = (long long)D * chunk;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS_X) blocks = MAX_BLOCKS_X;
  dim3 grid((unsigned)blocks, (unsigned)D);
  exchange_kernel<V><<<grid, THREADS, 0, stream>>>(
      ptrs, D, chunk, all_to_all ? chunk : 0);
  return cudaGetLastError();
}

int exchange(const void* const* srcs, void* const* dsts, int D,
             long long chunk_bytes, int unit, bool all_to_all,
             void* stream) {
  if (D < 1 || D > MAX_SHARDS || chunk_bytes <= 0 || unit <= 0 ||
      chunk_bytes % unit)
    return (int)cudaErrorInvalidValue;
  ShardPtrs ptrs{};
  for (int s = 0; s < D; ++s) {
    ptrs.src[s] = static_cast<const char*>(srcs[s]);
    ptrs.dst[s] = static_cast<char*>(dsts[s]);
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return (int)launch<uint4>(ptrs, D, chunk_bytes, all_to_all, st);
    case 8: return (int)launch<uint2>(ptrs, D, chunk_bytes, all_to_all, st);
    case 4:
      return (int)launch<uint32_t>(ptrs, D, chunk_bytes, all_to_all, st);
    case 2:
      return (int)launch<uint16_t>(ptrs, D, chunk_bytes, all_to_all, st);
    case 1: return (int)launch<uint8_t>(ptrs, D, chunk_bytes, all_to_all, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// srcs: D pointers to chunk_bytes each; dsts: D pointers to D*chunk_bytes
// each. unit: the copy width in bytes (16, 8, 4, 2 or 1), dividing
// chunk_bytes and every address.
extern "C" int all_gather_launch(const void* const* srcs, void* const* dsts,
                                 int D, long long chunk_bytes, int unit,
                                 void* stream) {
  return exchange(srcs, dsts, D, chunk_bytes, unit, false, stream);
}

// srcs and dsts: D pointers to D*chunk_bytes each; unit as above.
extern "C" int all_to_all_launch(const void* const* srcs, void* const* dsts,
                                 int D, long long chunk_bytes, int unit,
                                 void* stream) {
  return exchange(srcs, dsts, D, chunk_bytes, unit, true, stream);
}
