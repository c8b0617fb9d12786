// Chunked Mamba-2 SSD scan.  For every batch row b and head h (group
// g = h / (H / G)), over chunks of Q tokens in order, with the (N, P) state
// S carried from chunk to chunk (zero before the first):
//   cums[k] = sum_{j <= k} dt[j] * A[h]                (within the chunk)
//   y[i]    = sum_{k <= i} (C[i] . B[k]) e(cums[i] - cums[k]) dt[k] x[k]
//           + (C[i] e(cums[i])) S
//   S       = e(cums[Q-1]) S + sum_k (B[k] e(cums[Q-1] - cums[k]) dt[k]) x[k]^T
// where e(v) = exp(clip(v, -60, 0)).  f32 throughout; y is rounded to x's
// dtype once, the final state is returned in f32.  Rows past L count as
// zeros with dt = 0, as the reference's zero padding: they add nothing.
//
// Replaces the TPU kernel _ssd_kernel (src/repro/kernels/ssd/ssd.py:25):
// every layer's prefill of mamba2-2.7b, x (B, L, 80, 64) bf16, dt (B, L, 80)
// f32, B and C (B, L, 1, 128) bf16, Q = min(256, L).
//
// What bounds it on an H100: operations.  Counted as the TPU kernel does
// the work (C . B^T recomputed per head), one 200-token prefill is about
// 1.75 GFLOP against 6.9 MB, some 250 flops a byte, far above the 20 at
// which FP32 FMA (67 TFLOP/s, no tensor cores: the function is f32) stops
// waiting on memory.
//
// Design.  The TPU kernel walked a sequential chunk axis of its grid and
// kept the state in VMEM scratch.  Here a block walks the chunks of one
// (b, h) itself, with the state in shared memory (N x 64 f32, 32 KB at
// N = 128): no second pass, no atomics, a fixed order, so the result is
// deterministic.  (b, h) alone would give 80 blocks for one prefill on 132
// SMs, so each (b, h) has one block per 64-row slice of a chunk's query
// rows (320 blocks at Q = 200 or 256, two resident per SM): every slice's
// block computes its own rows of y in every chunk and carries its own copy
// of the state, updating it with the same arithmetic in the same order,
// so the copies are equal; the last chunk's update, which only makes the
// final state, is left to slice 0, whose causal share of the work is the
// smallest.  A chunk's Q x Q matrix of C . B^T does not fit (256 KB in
// f32 at Q = 256), so keys stream through shared memory in blocks of 32:
// for each key block the block computes the 64 x 32 tile of C . B^T (each
// thread 4 rows x 2 keys, N-long dots), applies the decay, the causal mask
// and dt, and accumulates the tile times the key block's x into a 64 x 64
// register tile of y (each thread 4 rows x 4 columns).  Then the state
// term, then y is written.  Then the keys stream once more to update the
// state (each thread 8 state rows x 4 columns at a time).  cums is one thread's
// sequential f32 sum (a product rounded, then a sum rounded, as the plain
// version's), so both versions see the same decays.  Padded row strides
// (N + 1) keep the 32 rows a warp reads in 32 banks.  The heads of a group
// each recompute C . B^T, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 64;        // query rows per step
constexpr int kKB = 32;        // key rows per step
constexpr int kPB = 64;        // head-dim columns held (P <= 64)
constexpr int kNS = 128;       // state rows per update pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);    // round to nearest even, as torch's cast
}

// exp(clip(v, -60, 0)); a NaN stays a NaN, as with jnp.clip
__device__ __forceinline__ float clip_exp(float v) {
  return expf(v < -60.0f ? -60.0f : (v > 0.0f ? 0.0f : v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ state_out, int L, int H, int P, int G,
               int N, int Q, int nc) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  float* st = smem;                      // N x kPB: the carried state
  float* cq = st + N * kPB;              // kQB x NS: C of the query block
  float* bk = cq + kQB * NS;             // kKB x NS: B of the key block
  float* xk = bk + kKB * NS;             // kKB x kPB: x of the key block
  float* mk = xk + kKB * kPB;            // kQB x (kKB + 1): the M tile
  float* cums = mk + kQB * (kKB + 1);    // Q
  float* dts = cums + Q;                 // Q
  float* w = dts + Q;                    // Q: the state update's weights

  const int h = blockIdx.x, b = blockIdx.y, slice = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  const size_t xrow = (size_t)H * P;     // x and y: one token to the next
  const size_t brow = (size_t)G * N;     // B and C
  const T* xb = x + (size_t)b * L * xrow + (size_t)h * P;
  T* yb = y + (size_t)b * L * xrow + (size_t)h * P;
  const T* bb = Bm + (size_t)b * L * brow + (size_t)g * N;
  const T* cb = Cm + (size_t)b * L * brow + (size_t)g * N;
  const float* dtb = dt + (size_t)b * L * H + h;

  for (int i = tid; i < N * kPB; i += kThreads) st[i] = 0.0f;

  // the key block [k0, k0 + kKB) of the chunk at l0: B (times w[k] when
  // given) and x, zeros past the chunk, past L and past P
  auto load_keys = [&](int l0, int k0, const float* wk) {
    for (int i = tid; i < kKB * N; i += kThreads) {
      const int k = i / N, n = i % N, kk = k0 + k, l = l0 + kk;
      float v = 0.0f;
      if (kk < Q && l < L) {
        v = to_f32(bb[(size_t)l * brow + n]);
        if (wk != nullptr) v *= wk[kk];
      }
      bk[k * NS + n] = v;
    }
    for (int i = tid; i < kKB * kPB; i += kThreads) {
      const int k = i / kPB, p = i % kPB, kk = k0 + k, l = l0 + kk;
      xk[i] = (kk < Q && l < L && p < P) ? to_f32(xb[(size_t)l * xrow + p])
                                         : 0.0f;
    }
  };

  for (int c = 0; c < nc; ++c) {
    const int l0 = c * Q;
    __syncthreads();                     // the last chunk is done with dts
    for (int k = tid; k < Q; k += kThreads)
      dts[k] = l0 + k < L ? dtb[(size_t)(l0 + k) * H] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int k = 0; k < Q; ++k) {
        run = __fadd_rn(run, __fmul_rn(dts[k], a));
        cums[k] = run;
      }
    }
    __syncthreads();

    {                                    // this block's query rows
      const int i0 = slice * kQB;
      const int qn = min(kQB, Q - i0);
      for (int i = tid; i < kQB * N; i += kThreads) {
        const int r = i / N, n = i % N, l = l0 + i0 + r;
        cq[r * NS + n] = (r < qn && l < L) ? to_f32(cb[(size_t)l * brow + n])
                                           : 0.0f;
      }
      float acc[4][4] = {};
      for (int k0 = 0; k0 < i0 + qn; k0 += kKB) {
        load_keys(l0, k0, nullptr);
        __syncthreads();
        float s[4][2] = {};
        for (int n = 0; n < N; ++n) {
          float cr[4], bj[2];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = cq[(ty * 4 + r) * NS + n];
#pragma unroll
          for (int j = 0; j < 2; ++j) bj[j] = bk[(tx * 2 + j) * NS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 2; ++j) s[r][j] = fmaf(cr[r], bj[j], s[r][j]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + tx * 2 + j;
            float m = 0.0f;
            if (k <= i && i < Q)
              m = s[r][j] * clip_exp(cums[i] - cums[k]) * dts[k];
            mk[(ty * 4 + r) * (kKB + 1) + tx * 2 + j] = m;
          }
        }
        __syncthreads();
        for (int k = 0; k < kKB; ++k) {
          float mr[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mr[r] = mk[(ty * 4 + r) * (kKB + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xk[k * kPB + tx * 4 + j];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(mr[r], xv[j], acc[r][j]);
        }
        __syncthreads();                 // before the next key block loads
      }
      // the state term, then y
      float e[4], acc2[4][4] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        e[r] = i < Q ? clip_exp(cums[i]) : 0.0f;
      }
      for (int n = 0; n < N; ++n) {
        float cr[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cq[(ty * 4 + r) * NS + n] * e[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[n * kPB + tx * 4 + j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[r][j] = fmaf(cr[r], sv[j], acc2[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = l0 + i0 + ty * 4 + r;
        if (ty * 4 + r >= qn || l >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx * 4 + j;
          if (p < P) store(yb + (size_t)l * xrow + p, acc[r][j] + acc2[r][j]);
        }
      }
      __syncthreads();                   // before the state update's loads
    }
    // the last chunk's update only makes the final state: one block does it
    if (c + 1 == nc && slice != 0) break;

    // the state update: the keys once more, weighted by
    // w[k] = e(cums[Q-1] - cums[k]) dt[k]
    const float last = cums[Q - 1];
    for (int k = tid; k < Q; k += kThreads)
      w[k] = clip_exp(last - cums[k]) * dts[k];
    const float lam = clip_exp(last);
    for (int n0 = 0; n0 < N; n0 += kNS) {
      float acc3[8][4] = {};
      for (int k0 = 0; k0 < Q; k0 += kKB) {
        __syncthreads();                 // w is written; bk/xk are free
        load_keys(l0, k0, w);
        __syncthreads();
        for (int k = 0; k < kKB; ++k) {
          float bv[8], xv[4];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = n0 + ty + 16 * q;
            bv[q] = n < N ? bk[k * NS + n] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xk[k * kPB + tx * 4 + j];
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc3[q][j] = fmaf(bv[q], xv[j], acc3[q][j]);
        }
      }
      // each thread rewrites only its own state entries, which no other
      // thread reads in this phase
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = n0 + ty + 16 * q;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = st + n * kPB + tx * 4 + j;
          *sp = __fadd_rn(__fmul_rn(lam, *sp), acc3[q][j]);
        }
      }
    }
  }
  if (slice != 0) return;
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads)
    so[i] = st[(i / P) * kPB + i % P];
}

size_t smem_bytes(int N, int Q) {
  return sizeof(float) * ((size_t)N * kPB + (size_t)kQB * (N + 1) +
                          (size_t)kKB * (N + 1) + (size_t)kKB * kPB +
                          (size_t)kQB * (kKB + 1) + 3 * (size_t)Q);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int Bb, int L, int H,
           int P, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = (L + Q - 1) / Q;
  const dim3 grid(H, Bb, (Q + kQB - 1) / kQB);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, L, H, P, G, N, Q,
      nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (Bb, L, H, P) and Bm, Cm (Bb, L, G, N) contiguous in one dtype
// (0 = float32, 1 = bfloat16); dt (Bb, L, H), A (H,) and state (Bb, H, N, P)
// float32; Q the chunk length (1 <= Q <= L).  The kernel's per-thread tiles
// need P <= 64 and the mask of the M tile needs the kKB-row key blocks.
extern "C" int repro_ssd(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, void* y, float* state,
                         int Bb, int L, int H, int P, int G, int N, int Q,
                         int dtype, cudaStream_t stream) {
  if (Bb <= 0 || Bb > 65535 || L <= 0 || H <= 0 || P <= 0 || P > kPB ||
      G <= 0 || H % G || N <= 0 || Q <= 0 || Q > L ||
      smem_bytes(N, Q) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, y, state, Bb, L, H, P, G, N, Q,
                           stream);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bb, L, H, P,
                                   G, N, Q, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
