// Two ways to read a weight stream once, for scripts/probe_weight_stream.py:
//   ldg:  a grid-stride loop in which each thread keeps U 16-byte loads in
//         flight straight into registers (what csrc/bfp_matmul.cu's GEMM
//         does with its weight words);
//   ring: each block streams its contiguous share through an S-stage ring
//         of 16-byte cp.async copies in shared memory, one copy a thread a
//         stage, and reads each stage back after a barrier.
// Both fold the bytes into one word, stored only if it hits a constant, so
// no load is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kNever = 0x9e3779b9u;

__device__ __forceinline__ unsigned fold(uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}

template <int U>
__global__ void ldg_stream(const uint4* __restrict__ src, long long n,
                           unsigned* __restrict__ sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (; i + (U - 1) * stride < n; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(src + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) acc ^= fold(v[u]);
  }
  for (; i < n; i += stride) acc ^= fold(__ldg(src + i));
  if (acc == kNever) *sink = acc;
}

template <int S>
__global__ void ring_stream(const uint4* __restrict__ src, long long n,
                            unsigned* __restrict__ sink) {
  extern __shared__ uint4 ring[];   // S stages of blockDim.x copies
  const int T = blockDim.x, tid = threadIdx.x;
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per, hi = min(lo + per, n);
  const long long tiles = hi > lo ? (hi - lo + T - 1) / T : 0;
  auto load = [&](long long t) {
    const long long i = lo + t * T + tid;
    cp_async16(reinterpret_cast<float*>(ring + (t % S) * T + tid),
               reinterpret_cast<const float*>(src + (i < hi ? i : 0)),
               i < hi);
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }
  unsigned acc = 0;
  for (long long t = 0; t < tiles; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();   // stage t landed; everyone is done with stage t - 1
    if (t + S - 1 < tiles) load(t + S - 1);
    cp_async_commit();
    acc ^= fold(ring[(t % S) * T + (tid ^ 1)]);   // a neighbour's copy
  }
  if (acc == kNever) *sink = acc;
}

template <typename K>
int run(K kernel, int blocks, int threads, int smem, const void* src,
        long long n, unsigned* sink, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const uint4*>(src), n,
                                            sink);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: ldg with depth = U loads in flight a thread (4 or 8); mode 1:
// ring with depth = S stages (4 or 8).  bytes: a multiple of 16
extern "C" int probe_stream(const void* src, long long bytes, unsigned* sink,
                            int mode, int blocks, int threads, int depth,
                            cudaStream_t stream) {
  if (bytes <= 0 || bytes % 16 || blocks <= 0 || threads <= 0 ||
      threads > 1024 || threads % 2)
    return (int)cudaErrorInvalidValue;
  const long long n = bytes / 16;
  const int ring = depth * threads * 16;
  if (mode == 0 && depth == 4)
    return run(ldg_stream<4>, blocks, threads, 0, src, n, sink, stream);
  if (mode == 0 && depth == 8)
    return run(ldg_stream<8>, blocks, threads, 0, src, n, sink, stream);
  if (mode == 1 && depth == 4)
    return run(ring_stream<4>, blocks, threads, ring, src, n, sink, stream);
  if (mode == 1 && depth == 8)
    return run(ring_stream<8>, blocks, threads, ring, src, n, sink, stream);
  return (int)cudaErrorInvalidValue;
}
