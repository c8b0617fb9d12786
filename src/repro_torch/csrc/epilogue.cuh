// Fused layer epilogue shared by the direct kernel (conv_direct.cu) and the
// fused Winograd kernel (conv_winograd.cu): cross-channel LRN, then VALID
// max-pool, read from the block's conv tile in shared memory; only the
// pooled map is written to device memory.
//
// Replaces the in-kernel half of the TPU epilogue
// (src/repro/kernels/conv/epilogue.py: lrn_banded, maxpool_strided,
// fused_epilogue).  The TPU phrased the LRN window sum as a banded matmul
// for its matrix unit; here each thread sums its n neighbours directly from
// shared memory, and LRN is evaluated per pool-window element (a pixel
// shared by overlapping windows is recomputed, with the same result), so no
// second full-channel buffer is needed.  The plain form of this math is
// repro_torch/nn/pooling.py.
#pragma once

#include <math.h>

#include "conv_args.cuh"

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

// y: the block's conv tile in shared memory, ct x ct pixels (row-major)
// of kt channels, whose origin is conv pixel (pi0 * ps, pj0 * ps).  Writes
// the block's PT x PT pooled outputs of image b, channels [kofs, kofs + kt)
// of out (B, ph_out, pw_out, g * K).  Call after __syncthreads().
__device__ __forceinline__ void fused_epilogue(const float* y, int ct, int kt,
                                               int kofs, int b, int pi0,
                                               int pj0, const ConvArgs& a,
                                               float* __restrict__ out) {
  const int kout = a.g * a.K;
  const int pr = min(a.PT, a.ph_out - pi0);
  const int pc = min(a.PT, a.pw_out - pj0);
  const int total = pr * pc * kt;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k = idx % kt;
    const int pix = idx / kt;
    const int i = pix / pc, j = pix % pc;
    float m = -INFINITY;
    for (int wi = 0; wi < a.pwin; ++wi) {
      for (int wj = 0; wj < a.pwin; ++wj) {
        const float* yp = y + ((i * a.ps + wi) * ct + (j * a.ps + wj)) * kt;
        m = nan_max(m, a.lrn_n ? lrn_at(yp, k, kt, a) : yp[k]);
      }
    }
    out[((size_t)(b * a.ph_out + pi0 + i) * a.pw_out + pj0 + j) * kout
        + kofs + k] = m;
  }
}
