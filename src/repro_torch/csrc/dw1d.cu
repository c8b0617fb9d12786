// Depthwise causal 1-D convolution by F(3,4) Winograd, Mamba-2's conv of
// the x stream:
//   out[b, t, c] = sum_k w[k, c] * x[b, t - 3 + k, c] + bias[c]
// with x left-padded by r - 1 = 3 zeros.  Each tile j of n = 6 inputs
// (x[3j-3 .. 3j+2]) gives m = 3 outputs (rows 3j .. 3j+2):
//   y = A^T ((G w) * (B^T d))
// in f32, then the bias in f32, then one rounding to x's dtype.  Inputs
// past L read as zeros (the reference pads the ragged last tile), so the
// Winograd transform of the last tile sees what the reference's does.
//
// Replaces the TPU kernel _dw1d_kernel (src/repro/kernels/conv/
// winograd.py:61): mamba2-2.7b's x stream, x (B, L, 5120) bf16, w (4, 5120)
// and bias (5120,) f32, once per layer per prefill.
//
// What bounds it on an H100: bytes.  A tile costs 114 flops (36 FMAs for
// B^T d, 6 products, 18 FMAs for A^T) for 3 outputs, about 38 flops an
// output against 4 bytes moved in bf16 (one read, one write): 9.5 flops a
// byte, under the 20 at which FP32 FMA (67 TFLOP/s) would overtake the
// 3.35 TB/s of device memory.  The TPU
// kernel built the overlapping 6-tap tiles in VMEM from stride-3 slices of
// a raw slab; here one thread owns one channel and a run of kTiles
// consecutive tiles, and keeps the 6-tap window in registers: each tile
// reads 3 new rows and reuses the 3 it already holds, so the raw sequence
// is read once (plus a 3-row halo per run) and no tile tensor exists
// anywhere.  Lanes of a warp take neighbouring channels, so every row read
// and write is coalesced along C.  G w is computed once per thread.  The
// transform matrices are the reference's (winograd_transform(3, 4), a
// float64 least-squares solve rounded to f32), passed in by the host.
// Plain FP32 FMA, a fixed order per output, no atomics: deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTiles = 8;       // tiles (24 output rows) per thread
constexpr int kM = 3, kR = 4, kN = kM + kR - 1;

struct Dw1dMats {
  float bt[kN * kN];            // B^T (6, 6)
  float g[kN * kR];             // G (6, 4)
  float at[kM * kN];            // A^T (3, 6)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);     // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, Dw1dMats mt,
                T* __restrict__ out, int L, int C, int nt) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int j0 = blockIdx.y * kTiles;
  const size_t base = (size_t)blockIdx.z * L * C + c;
  const T* xc = x + base;
  T* oc = out + base;

  float v[kN];                  // filter transform G w
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kR; ++k) s = fmaf(mt.g[t * kR + k], w[k * C + c], s);
    v[t] = s;
  }
  const float bc = bias[c];

  // window d[i] = x[s + i], s = 3j - 3; rows outside [0, L) are zeros
  float d[kN];
  const int s0 = kM * j0 - (kR - 1);
#pragma unroll
  for (int i = 0; i < kN - kM; ++i) {
    const int s = s0 + i;
    d[i] = (s >= 0 && s < L) ? to_f32(xc[(size_t)s * C]) : 0.0f;
  }
  for (int jj = 0; jj < kTiles; ++jj) {
    const int j = j0 + jj;
    if (j >= nt) break;
    const int s = kM * j - (kR - 1);
#pragma unroll
    for (int i = kN - kM; i < kN; ++i) {
      const int row = s + i;
      d[i] = row < L ? to_f32(xc[(size_t)row * C]) : 0.0f;
    }
    float p[kN];                // (G w) * (B^T d)
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      float u = 0.0f;
#pragma unroll
      for (int i = 0; i < kN; ++i) u = fmaf(mt.bt[t * kN + i], d[i], u);
      p[t] = u * v[t];
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int row = kM * j + m;
      if (row < L) {
        float y = 0.0f;
#pragma unroll
        for (int t = 0; t < kN; ++t) y = fmaf(mt.at[m * kN + t], p[t], y);
        store(oc + (size_t)row * C, y + bc);
      }
    }
#pragma unroll
    for (int i = 0; i < kN - kM; ++i) d[i] = d[i + kM];
  }
}

template <typename T>
int launch(const void* x, const float* w, const float* bias,
           const Dw1dMats& mt, void* out, int B, int L, int C,
           cudaStream_t stream) {
  const int nt = (L + kM - 1) / kM;
  const dim3 grid((C + kThreads - 1) / kThreads, (nt + kTiles - 1) / kTiles,
                  B);
  dw1d_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, bias, mt, static_cast<T*>(out), L, C, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (B, L, C) contiguous in one dtype (0 = float32, 1 = bfloat16);
// w (4, C) and bias (C,) float32; mats: host array of B^T (6x6), G (6x4)
// and A^T (3x6), row-major.
extern "C" int repro_dw1d(const void* x, const float* w, const float* bias,
                          const float* mats, void* out, int B, int L, int C,
                          int dtype, cudaStream_t stream) {
  if (mats == nullptr || B <= 0 || B > 65535 || L <= 0 || C <= 0 ||
      (L + kM - 1) / kM > 65535 * kTiles)
    return (int)cudaErrorInvalidValue;
  Dw1dMats mt;
  for (int i = 0; i < kN * kN; ++i) mt.bt[i] = mats[i];
  for (int i = 0; i < kN * kR; ++i) mt.g[i] = mats[kN * kN + i];
  for (int i = 0; i < kM * kN; ++i) mt.at[i] = mats[kN * kN + kN * kR + i];
  switch (dtype) {
    case 0:
      return launch<float>(x, w, bias, mt, out, B, L, C, stream);
    case 1:
      return launch<__nv_bfloat16>(x, w, bias, mt, out, B, L, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
