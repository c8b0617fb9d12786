// Fused layer epilogue shared by the direct kernel (conv_direct.cu) and the
// Winograd kernels (conv_winograd.cu): cross-channel LRN, then VALID
// max-pool, read from the conv map their conv stage left in L2; only the
// pooled map is written.
//
// Replaces the in-kernel half of the TPU epilogue
// (src/repro/kernels/conv/epilogue.py: lrn_banded, maxpool_strided,
// fused_epilogue).  The TPU phrased the LRN window sum as a banded matmul
// for its matrix unit; here each thread sums its n neighbours directly from
// the conv map, and LRN is evaluated per pool-window element (a pixel
// shared by overlapping windows is recomputed, with the same result), so no
// second full-channel buffer is needed.  The plain form of this math is
// repro_torch/nn/pooling.py.
//
// Element types: x, the bias and the output are f32 or bf16 (ConvArgs.xdt),
// the slab f32 or bf16 (ConvArgs.sdt).  Loads widen to f32 (exact), every
// sum, the bias, ReLU, LRN and pool run in f32, conv maps between launches
// stay f32, and only the final store rounds to bf16, to nearest even, as
// the reference's one cast of its f32 result does.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "conv_args.cuh"

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// out[i] = v in the output's element type (bf16: round to nearest even).
__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(out)[i] = v;
}

// Bias, then ReLU that keeps NaN (a poisoned input must stay visible).
__device__ __forceinline__ float bias_relu(float v, float bias, int relu) {
  v += bias;
  return (relu && v < 0.f) ? 0.f : v;
}

// LRN of channel k at one conv pixel; y points at channel 0 of that pixel
// (kt channels).  Channels outside [0, kt) contribute zeros.
__device__ __forceinline__ float lrn_at(const float* y, int k, int kt,
                                        const ConvArgs& a) {
  const int half = a.lrn_n / 2;
  float win = 0.f;
  for (int d = -half; d <= half; ++d) {
    const int kk = k + d;
    if (kk >= 0 && kk < kt) win = fmaf(y[kk], y[kk], win);
  }
  return y[k] / powf(a.lrn_k + a.lrn_alpha / a.lrn_n * win, a.lrn_beta);
}

// Max that propagates NaN, like the plain version's torch.maximum.
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// One block of an epilogue launch with grid (pooled tiles of PT x PT, B):
// the block's PT x PT pooled outputs of image blockIdx.y, all g * K
// channels, from the f32 conv map y (B, out_h, out_w, g * K) into out (B,
// ph_out, pw_out, g * K) in x's element type.
__device__ __forceinline__ void fused_epilogue(const ConvArgs& a,
                                               const float* __restrict__ y,
                                               void* __restrict__ out) {
  const bool bf16 = a.xdt == kBf16;
  const int kf = a.g * a.K;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  const int pi0 = (blockIdx.x / npw) * a.PT;
  const int pj0 = (blockIdx.x % npw) * a.PT;
  const int b = blockIdx.y;
  const float* yb =
      y + (((size_t)b * a.out_h + pi0 * a.ps) * a.out_w + pj0 * a.ps) * kf;
  const int pr = min(a.PT, a.ph_out - pi0);
  const int pc = min(a.PT, a.pw_out - pj0);
  const int total = pr * pc * kf;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k = idx % kf;
    const int pix = idx / kf;
    const int i = pix / pc, j = pix % pc;
    float m = -INFINITY;
    for (int wi = 0; wi < a.pwin; ++wi) {
      for (int wj = 0; wj < a.pwin; ++wj) {
        const float* yp =
            yb + ((size_t)(i * a.ps + wi) * a.out_w + (j * a.ps + wj)) * kf;
        m = nan_max(m, a.lrn_n ? lrn_at(yp, k, kf, a) : yp[k]);
      }
    }
    store_out(out,
              ((size_t)(b * a.ph_out + pi0 + i) * a.pw_out + pj0 + j) * kf
                  + k,
              m, bf16);
  }
}
