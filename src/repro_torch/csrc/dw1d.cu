// Depthwise causal 1-D convolution by F(m,r) Winograd, Mamba-2's conv of
// the x stream, for r = 2..11 taps at the reference's m = {3: 4, 4: 3}
// .get(r, 2) (SSMCfg.conv_kernel = r):
//   out[b, t, c] = sum_k w[k, c] * x[b, t - (r-1) + k, c] + bias[c]
// with x left-padded by r - 1 zeros.  Each tile j of n = m + r - 1 inputs
// (x[mj-(r-1) .. mj+m-1]) gives m outputs (rows mj .. mj+m-1):
//   y = A^T ((G w) * (B^T d))
// in f32, then the bias in f32, then one rounding to x's dtype.  Inputs
// past L read as zeros (the reference pads the ragged last tile), so the
// Winograd transform of the last tile sees what the reference's does.
//
// Replaces the TPU kernel _dw1d_kernel (src/repro/kernels/conv/
// winograd.py:61): mamba2-2.7b's x stream, x (B, L, 5120) bf16, w (4, 5120)
// and bias (5120,) f32, once per layer per prefill.
//
// What bounds it on an H100: bytes.  The function is r multiply-adds and a
// bias add an output, 2r + 1 flops (chip_smoke.dw1d_work): 23 at r = 11,
// against 4 bytes moved an output in bf16 (one read, one write), under
// the 20 flops a byte at which FP32 FMA (67 TFLOP/s) would overtake the
// 3.35 TB/s of device memory, at every tap count.  The Winograd
// transforms cost more than that (117 flops for F(3,4)'s 3 outputs, 350
// for F(2,11)'s 2), work of the algorithm and not of the function.  At
// the served 200 tokens the whole call moves 4.1 MB, so what it costs is
// the latency of its memory round trips, not their bandwidth.
//
// Design.  The TPU kernel built the overlapping n-tap tiles in VMEM from
// stride-m slices of a raw slab.  Here a block of 128 lanes owns 256
// channels, two a lane, and one run of TT tiles (TT in {1, 2, 4}); the
// wrapper picks TT from the shape (kernels/conv/winograd.py: dw1d_launch)
// so that the grid fills the card at least twice.  All of the run's
// m TT + r - 1 rows come into shared memory at once, by 16-byte cp.async
// copies (zeros outside [0, L) and past C; one element a thread where C or
// the buffers are not 16-byte aligned, as for C = 5), and G w is computed
// while they fly.  A lane takes n rows of its two channels into
// registers a tile, computes the tile and writes its m outputs over
// rows it has read; the block then stores the run's outputs with 16-byte
// stores.  Every load and store is coalesced along C.  The transform
// matrices are the reference's (winograd_transform(m, r), a float64
// least-squares solve rounded to f32), passed in by the host.  Each
// output's fmaf chains are the same for every TT (and, at F(3,4), the
// same as this kernel's first version), so the output does not depend on
// it.  (m, r) are template arguments: one instantiation per tap count, the
// reference's m for it.  No atomics: deterministic.
//
// The backward (kernel 7's VJP, the reference's _dw1d_bwd at
// src/repro/kernels/conv/ops.py:47, which re-runs the Pallas kernel on the
// time-reversed cotangent) is two more entries:
//   * dx: this kernel in its time-reversed mode (`rev`): it reads input
//     row L-1-t where the forward reads row t and writes output row L-1-t,
//     with a zero bias.  The tiles are those of the forward on the reversed
//     sequence, so dx is bit-equal to flip(kernel7(flip(dy))) and the two
//     flips are never copied.
//   * dw, db: repro_dw1d_wgrad, a reduction over (b, t).  Bound by bytes
//     (x and dy read once: 2r + 1 flops a pair of elements).  A block owns
//     128 channels, one a lane, and a split of one batch row's time steps;
//     a lane walks its rows with x[t-r+1..t-1] in registers and sums the r
//     tap products and dy in f32, and writes the r + 1 sums to a per-block
//     partial.  A second launch adds the partials of each channel in split
//     order.  No atomics: two runs give the same bits.  dw stays f32; db is
//     rounded once to dy's type (the reference sums dy in dy's dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;   // lanes a block
constexpr int kCh = 2 * kThreads;   // channels a block, two a lane
constexpr int kMaxR = 11;

// F(M,R)'s B^T (n, n), G (n, r) and A^T (m, n), row-major with row strides
// n, r, n: sized per instantiation, so each launch passes only its own
// (F(3,4): 78 floats)
template <int M, int R>
struct Dw1dMats {
  static constexpr int kN = M + R - 1;
  float bt[kN * kN];
  float g[kN * R];
  float at[M * kN];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// Rows m j0 - (r-1) .. m (j0 + TT) - 1 of channels [c0, c0 + kCh) into
// `tile`: 16-byte cp.async copies where `vec` (zeros outside [0, L) and
// past C), else one element a thread.  Row s is x's row s, or row L-1-s
// when `rev`
template <typename T, int TT, int M, int R>
__device__ __forceinline__ void load_run(T (*tile)[kCh], const T* x, int L,
                                         int C, size_t bb, int c0, int j0,
                                         bool vec, bool rev) {
  constexpr int kRows = M * TT + R - 1;
  constexpr int kV = 16 / (int)sizeof(T), kChunks = kCh / kV;
  const int s0 = M * j0 - (R - 1);
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, q = (i % kChunks) * kV;
      const int row = s0 + r, ch = c0 + q;
      const bool ok = row >= 0 && row < L && ch < C;
      const int src = rev ? L - 1 - row : row;
      cp_async16(reinterpret_cast<float*>(&tile[r][q]),
                 reinterpret_cast<const float*>(
                     ok ? x + bb + (size_t)src * C + ch : x),
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCh; i += kThreads) {
      const int r = i / kCh, q = i % kCh;
      const int row = s0 + r, ch = c0 + q;
      tile[r][q] = (row >= 0 && row < L && ch < C)
                       ? x[bb + (size_t)(rev ? L - 1 - row : row) * C + ch]
                       : to_t<T>(0.0f);
    }
  }
}

// A block owns channels [c0, c0 + kCh) of batch row z and the run of TT
// tiles j0 = blockIdx.y TT of F(M, R).  The run's rows come into shared
// memory by 16-byte cp.async copies while G w is made.  Each lane computes
// its two channels' TT tiles from the buffer, n rows in registers at a
// time, and writes its outputs over the rows it has read; the block then
// stores the run's output rows with 16-byte stores.  With `rev` the rows
// are read and written time-reversed (row s of the run is x's and out's
// row L-1-s).
template <typename T, int TT, int M, int R>
__global__ void __launch_bounds__(kThreads)
    dw1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, Dw1dMats<M, R> mt,
                T* __restrict__ out, int L, int C, bool vec, bool rev) {
  constexpr int kN = M + R - 1;
  constexpr int kRows = M * TT + R - 1;
  constexpr int kV = 16 / (int)sizeof(T), kChunks = kCh / kV;
  __shared__ __align__(16) T tile[kRows][kCh];
  const int tid = threadIdx.x, c0 = blockIdx.x * kCh;
  const size_t bb = (size_t)blockIdx.z * L * C;

  // the run's rows fly while G w is made
  load_run<T, TT, M, R>(tile, x, L, C, bb, c0, blockIdx.y * TT, vec, rev);
  cp_async_commit();
  const int q0 = 2 * tid, c = c0 + q0;           // this lane's channels
  float v[2][kN], bc[2];                         // G w of each channel
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const bool ok = c + q < C;
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc = fmaf(mt.g[t * R + k], ok ? w[k * C + c + q] : 0.0f, acc);
      v[q][t] = acc;
    }
    bc[q] = ok ? bias[c + q] : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();                               // the run's rows are in

  // tile jj reads rows M jj .. M jj + n - 1 of the lane's columns and
  // writes its outputs over rows M jj .. M jj + M - 1, which no later tile
  // reads
#pragma unroll 1
  for (int jj = 0; jj < TT; ++jj) {
    float d[kN][2];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) d[i][q] = to_f32(tile[M * jj + i][q0 + q]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float p[kN];                               // (G w) * (B^T d)
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        float u = 0.0f;
#pragma unroll
        for (int i = 0; i < kN; ++i) u = fmaf(mt.bt[t * kN + i], d[i][q], u);
        p[t] = u * v[q][t];
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kN; ++t) acc = fmaf(mt.at[m * kN + t], p[t], acc);
        tile[M * jj + m][q0 + q] = to_t<T>(acc + bc[q]);
      }
    }
  }
  __syncthreads();                               // the outputs are in
  const int r0 = M * blockIdx.y * TT, rows = min(M * TT, L - r0);
  if (vec) {
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, q = (i % kChunks) * kV;
      const int row = rev ? L - 1 - (r0 + r) : r0 + r;
      if (c0 + q < C)
        *reinterpret_cast<uint4*>(out + bb + (size_t)row * C + c0 + q) =
            *reinterpret_cast<const uint4*>(&tile[r][q]);
    }
  } else {
    for (int i = tid; i < rows * kCh; i += kThreads) {
      const int r = i / kCh, q = i % kCh;
      const int row = rev ? L - 1 - (r0 + r) : r0 + r;
      if (c0 + q < C) out[bb + (size_t)row * C + c0 + q] = tile[r][q];
    }
  }
}

template <typename T, int TT, int M, int R>
int launch(const void* x, const float* w, const float* bias,
           const Dw1dMats<M, R>& mt, void* out, int B, int L, int C,
           bool rev, cudaStream_t stream) {
  const int runs = ((L + M - 1) / M + TT - 1) / TT;
  if (runs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kCh - 1) / kCh, runs, B);
  // 16-byte copies when every row starts on a 16-byte boundary
  const bool vec = (C * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dw1d_kernel<T, TT, M, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, bias, mt, static_cast<T*>(out), L, C, vec,
      rev);
  return (int)cudaGetLastError();
}

template <typename T, int M, int R>
int launch_tiles(const void* x, const float* w, const float* bias,
                 const float* mats, void* out, int B, int L, int C,
                 int tiles, bool rev, cudaStream_t stream) {
  constexpr int kN = Dw1dMats<M, R>::kN;
  Dw1dMats<M, R> mt;
  for (int i = 0; i < kN * kN; ++i) mt.bt[i] = mats[i];
  for (int i = 0; i < kN * R; ++i) mt.g[i] = mats[kN * kN + i];
  for (int i = 0; i < M * kN; ++i) mt.at[i] = mats[kN * kN + kN * R + i];
  switch (tiles) {
    case 1:
      return launch<T, 1, M, R>(x, w, bias, mt, out, B, L, C, rev, stream);
    case 2:
      return launch<T, 2, M, R>(x, w, bias, mt, out, B, L, C, rev, stream);
    case 4:
      return launch<T, 4, M, R>(x, w, bias, mt, out, B, L, C, rev, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the reference's m for r taps: {3: 4, 4: 3}.get(r, 2)
__host__ __device__ constexpr int default_m(int r) {
  return r == 3 ? 4 : r == 4 ? 3 : 2;
}

// Calls F(default_m(r), r)'s instantiation of fn for r = 2..11 (the
// kernel's tap counts); any other (m, r) is refused.
#define REPRO_DW1D_TAPS(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11)

template <typename T>
int launch_taps(int m, int r, const void* x, const float* w,
                const float* bias, const float* mats, void* out, int B,
                int L, int C, int tiles, bool rev, cudaStream_t stream) {
  if (r < 2 || r > kMaxR || m != default_m(r))
    return (int)cudaErrorInvalidValue;
  switch (r) {
#define REPRO_DW1D_CASE(RR)                                                \
  case RR:                                                                 \
    return launch_tiles<T, default_m(RR), RR>(x, w, bias, mats, out, B, L,  \
                                              C, tiles, rev, stream);
    REPRO_DW1D_TAPS(REPRO_DW1D_CASE)
#undef REPRO_DW1D_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// dw and db: per-block partial sums, then a fixed-order second pass
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 128;     // channels a block, one a lane

// Block (channel block, split, batch row b): lane c sums, over rows
// [split * rows, min(L, (split + 1) * rows)) of batch row b,
// dy[t] * x[t - (R-1) + k] for the R taps k and dy[t] itself, in f32, and
// writes the R + 1 sums to part[(b * splits + split) * (R + 1) + k][c]
template <typename T, int R>
__global__ void __launch_bounds__(kWgThreads)
    dw1d_wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ part, int L, int C, int rows) {
  const int c = blockIdx.x * kWgThreads + threadIdx.x;
  if (c >= C) return;
  const int t0 = blockIdx.y * rows, t1 = min(L, t0 + rows);
  const size_t bb = (size_t)blockIdx.z * L * C + c;
  // xs[k] = x[t - (R-1) + k] of this lane's channel (zeros before t = 0)
  float xs[R - 1];
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {
    const int s = t0 - (R - 1) + k;
    xs[k] = s >= 0 ? to_f32(x[bb + (size_t)s * C]) : 0.0f;
  }
  float a[R + 1];
#pragma unroll
  for (int k = 0; k <= R; ++k) a[k] = 0.0f;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const float xt = to_f32(x[bb + (size_t)t * C]);
    const float g = to_f32(dy[bb + (size_t)t * C]);
#pragma unroll
    for (int k = 0; k < R - 1; ++k) a[k] = fmaf(g, xs[k], a[k]);
    a[R - 1] = fmaf(g, xt, a[R - 1]);
    a[R] += g;
#pragma unroll
    for (int k = 0; k < R - 2; ++k) xs[k] = xs[k + 1];
    xs[R - 2] = xt;
  }
  float* p =
      part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * (R + 1) * C + c;
#pragma unroll
  for (int k = 0; k <= R; ++k) p[k * (size_t)C] = a[k];
}

// Lane c adds its channel's S partials in order: dw[k][c] in f32, db[c]
// rounded once to T and widened back to f32
template <typename T, int R>
__global__ void __launch_bounds__(kWgThreads)
    dw1d_wgrad_final(const float* __restrict__ part, float* __restrict__ dw,
                     float* __restrict__ db, int C, int S) {
  const int c = blockIdx.x * kWgThreads + threadIdx.x;
  if (c >= C) return;
  float acc[R + 1];
#pragma unroll
  for (int k = 0; k <= R; ++k) acc[k] = 0.0f;
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int k = 0; k <= R; ++k)
      acc[k] += part[((size_t)s * (R + 1) + k) * C + c];
#pragma unroll
  for (int k = 0; k < R; ++k) dw[(size_t)k * C + c] = acc[k];
  db[c] = to_f32(to_t<T>(acc[R]));
}

template <typename T, int R>
int launch_wgrad(const void* x, const void* dy, float* part, float* dw,
                 float* db, int B, int L, int C, int rows,
                 cudaStream_t stream) {
  const int splits = (L + rows - 1) / rows;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const int cb = (C + kWgThreads - 1) / kWgThreads;
  dw1d_wgrad_partial<T, R><<<dim3(cb, splits, B), kWgThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, L, C, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dw1d_wgrad_final<T, R><<<cb, kWgThreads, 0, stream>>>(part, dw, db, C,
                                                         B * splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad_taps(int r, const void* x, const void* dy, float* part,
                      float* dw, float* db, int B, int L, int C, int rows,
                      cudaStream_t stream) {
  switch (r) {
#define REPRO_DW1D_CASE(RR)                                                \
  case RR:                                                                 \
    return launch_wgrad<T, RR>(x, dy, part, dw, db, B, L, C, rows, stream);
    REPRO_DW1D_TAPS(REPRO_DW1D_CASE)
#undef REPRO_DW1D_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out (B, L, C) contiguous in one dtype (0 = float32, 1 = bfloat16);
// w (r, C) and bias (C,) float32, r = 2..11 taps at m = default_m(r)
// outputs a tile; mats: host array of B^T (n x n), G (n x r) and A^T (m x
// n), row-major, n = m + r - 1; tiles: Winograd tiles a block (1, 2 or
// 4); reverse: nonzero to read and write the rows time-reversed (the dx of
// the backward, with a zero bias).
extern "C" int repro_dw1d(const void* x, const float* w, const float* bias,
                          const float* mats, void* out, int B, int L, int C,
                          int m, int r, int tiles, int reverse, int dtype,
                          cudaStream_t stream) {
  if (mats == nullptr || B <= 0 || B > 65535 || L <= 0 || C <= 0 || r < 2
      || r > kMaxR || m != default_m(r))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_taps<float>(m, r, x, w, bias, mats, out, B, L, C, tiles,
                                reverse != 0, stream);
    case 1:
      return launch_taps<__nv_bfloat16>(m, r, x, w, bias, mats, out, B, L,
                                        C, tiles, reverse != 0, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dw (r, C) and db (C,) float32 of the depthwise conv's backward from x and
// dy (B, L, C) contiguous in one dtype (0 = float32, 1 = bfloat16), r =
// 2..11 taps; part: the f32 scratch of B * ceil(L / rows) * (r + 1) * C
// partial sums; rows: time steps a block.
extern "C" int repro_dw1d_wgrad(const void* x, const void* dy, float* part,
                                float* dw, float* db, int B, int L, int C,
                                int r, int rows, int dtype,
                                cudaStream_t stream) {
  if (B <= 0 || B > 65535 || L <= 0 || C <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_wgrad_taps<float>(r, x, dy, part, dw, db, B, L, C, rows,
                                      stream);
    case 1:
      return launch_wgrad_taps<__nv_bfloat16>(r, x, dy, part, dw, db, B, L,
                                              C, rows, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
