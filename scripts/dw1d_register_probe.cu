// Kernel 7 (csrc/dw1d.cu) with its rows staged in registers instead of
// shared memory, for scripts/probe_dw1d_registers.py.  A block of 128
// lanes owns 256 channels, two a lane, and one run of TT tiles, as kernel 7
// does; here each lane loads all 3 TT + 3 rows of its two channels
// (bf16x2 or float2, one 4- or 8-byte load a row) into registers before
// any arithmetic, fully unrolled and predicated, and stores its outputs
// two channels at a time.  Each output's fmaf chains are kernel 7's, so
// the two give the same bits.  Takes an even C and 8-byte aligned x and
// out only (mamba2-2.7b's x stream).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, kCh = 2 * kThreads;
constexpr int kM = 3, kR = 4, kN = kM + kR - 1;

struct Mats {
  float bt[kN * kN];
  float g[kN * kR];
  float at[kM * kN];
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ void store2(float2* p, float a, float b) {
  *p = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat162* p, float a, float b) {
  __nv_bfloat162 r;
  r.x = __float2bfloat16(a);
  r.y = __float2bfloat16(b);
  *p = r;
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
    dw1d_regs(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, Mats mt, T* __restrict__ out,
              int L, int C) {
  using T2 = typename Pair<T>::type;
  constexpr int kRows = kM * TT + kN - kM;
  const int c = blockIdx.x * kCh + 2 * threadIdx.x;
  const bool okc = c < C;
  const size_t bb = (size_t)blockIdx.z * L * C;
  const int s0 = kM * blockIdx.y * TT - (kR - 1);
  float2 d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = s0 + r;
    d[r] = (okc && row >= 0 && row < L)
               ? to_f2(*reinterpret_cast<const T2*>(x + bb +
                                                    (size_t)row * C + c))
               : make_float2(0.0f, 0.0f);
  }
  float v[2][kN], bc[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kR; ++k)
        acc = fmaf(mt.g[t * kR + k], okc ? w[k * C + c + q] : 0.0f, acc);
      v[q][t] = acc;
    }
    bc[q] = okc ? bias[c + q] : 0.0f;
  }
#pragma unroll
  for (int jj = 0; jj < TT; ++jj) {
    float y[kM][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float p[kN];
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        float u = 0.0f;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float2 di = d[kM * jj + i];
          u = fmaf(mt.bt[t * kN + i], q ? di.y : di.x, u);
        }
        p[t] = u * v[q][t];
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kN; ++t) acc = fmaf(mt.at[m * kN + t], p[t], acc);
        y[m][q] = acc + bc[q];
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int row = s0 + kR - 1 + kM * jj + m;
      if (okc && row < L)
        store2(reinterpret_cast<T2*>(out + bb + (size_t)row * C + c),
               y[m][0], y[m][1]);
    }
  }
}

template <typename T, int TT>
int launch(const void* x, const float* w, const float* bias, const Mats& mt,
           void* out, int B, int L, int C, cudaStream_t stream) {
  const int runs = ((L + kM - 1) / kM + TT - 1) / TT;
  if (runs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kCh - 1) / kCh, runs, B);
  dw1d_regs<T, TT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, bias, mt, static_cast<T*>(out), L, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tiles(const void* x, const float* w, const float* bias,
                 const Mats& mt, void* out, int B, int L, int C, int tiles,
                 cudaStream_t stream) {
  switch (tiles) {
    case 1:
      return launch<T, 1>(x, w, bias, mt, out, B, L, C, stream);
    case 2:
      return launch<T, 2>(x, w, bias, mt, out, B, L, C, stream);
    case 4:
      return launch<T, 4>(x, w, bias, mt, out, B, L, C, stream);
    case 8:
      return launch<T, 8>(x, w, bias, mt, out, B, L, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kernel 7's C entry (csrc/dw1d.cu: repro_dw1d), with tiles in {1, 2, 4, 8}
extern "C" int probe_dw1d_regs(const void* x, const float* w,
                               const float* bias, const float* mats,
                               void* out, int B, int L, int C, int tiles,
                               int dtype, cudaStream_t stream) {
  if (mats == nullptr || B <= 0 || B > 65535 || L <= 0 || C <= 0 || C % 2 ||
      reinterpret_cast<uintptr_t>(x) % 8 || reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  Mats mt;
  for (int i = 0; i < kN * kN; ++i) mt.bt[i] = mats[i];
  for (int i = 0; i < kN * kR; ++i) mt.g[i] = mats[kN * kN + i];
  for (int i = 0; i < kM * kN; ++i) mt.at[i] = mats[kN * kN + kN * kR + i];
  switch (dtype) {
    case 0:
      return launch_tiles<float>(x, w, bias, mt, out, B, L, C, tiles, stream);
    case 1:
      return launch_tiles<__nv_bfloat16>(x, w, bias, mt, out, B, L, C, tiles,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
