// Strided direct conv layer: conv + bias + ReLU + cross-channel LRN + VALID
// max-pool in one kernel, for any filter size, stride, groups and padding.
//
// Replaces the TPU kernel _direct_kernel (src/repro/kernels/conv/direct.py,
// launched by conv2d_direct): AlexNet conv1 (11x11 stride 4, 3 -> 96) and
// conv2 (5x5, groups 2, 96 -> 256), both with LRN and a 3/2 pool.
//
// What bounds it on an H100: operations.  conv2 at batch 8 is 1.8 G
// multiply-adds against 5 MB of input, weights and output; conv1 is
// 0.84 G against 7 MB.  There is no FP32 tensor-core path, so the roof is
// the 67 TFLOP/s of the FMA pipes.
//
// Design.  The TPU walked a sequential grid and carried partial sums in
// scratch across channel blocks (acc_ref) and K blocks (y_ref).  GPU blocks
// run in no order, so one thread block owns one image and one tile of
// PT x PT pooled outputs, and loops over every group, K chunk and channel
// block itself.  Cross-channel LRN needs all g*K channels of a pixel
// (across the group seam) and the pool needs a spatial halo, so the block
// computes its whole conv tile, (ps*(PT-1)+pwin)^2 pixels x g*K channels,
// into shared memory (conv1: 9x9x96 floats = 31 KB, conv2: 9x9x256 = 83 KB,
// dynamic shared memory), recomputing the pool halo its neighbours also
// compute, then runs the epilogue (epilogue.cuh) and writes only the pooled
// map.  Each thread accumulates a 4-pixel x 4-channel register tile in
// plain FP32 FMA (no TF32, no atomics: every output is one thread's fixed
// sum order, so results are deterministic); lanes of a warp take
// neighbouring output channels, so slab reads are coalesced along Kb and
// the input value is a broadcast.  Weights are read in the packed slab
// layout (tile lin = k * ncb + c of (r, r, Cb, Kb)) through L1/L2; only the
// C real channels of each group are read, so channel padding in the slab
// is never touched, and out-of-range input pixels (SAME padding, the rows
// and columns a strided VALID conv never reaches) read as zeros.
#include <cuda_runtime.h>

#include "conv_args.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;     // conv pixels per thread
constexpr int kChan = 4;    // output channels per thread (strided by 32)

__global__ void __launch_bounds__(kThreads)
conv_direct_kernel(ConvArgs a, const float* __restrict__ x,
                   const float* __restrict__ slab,
                   const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ float ytile[];            // ct * ct * kf
  const int kf = a.g * a.K;
  const int ct = a.ps * (a.PT - 1) + a.pwin;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  const int pi0 = (blockIdx.x / npw) * a.PT;
  const int pj0 = (blockIdx.x % npw) * a.PT;
  const int b = blockIdx.y;
  const int cy0 = pi0 * a.ps, cx0 = pj0 * a.ps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npix = ct * ct;
  const int npg = (npix + kPix - 1) / kPix;
  const int nkc = (a.K + 32 * kChan - 1) / (32 * kChan);
  const int items = a.g * nkc * npg;
  const size_t tile_elems = (size_t)a.r * a.r * a.Cb * a.Kb;

  for (int it = warp; it < items; it += kThreads / 32) {
    const int pg = it % npg;
    const int kc = (it / npg) % nkc;
    const int grp = it / (npg * nkc);

    int py[kPix], px[kPix];
    bool pv[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int pix = pg * kPix + p;
      py[p] = cy0 + pix / ct;
      px[p] = cx0 + pix % ct;
      pv[p] = pix < npix && py[p] < a.out_h && px[p] < a.out_w;
    }
    int kin[kChan];
    bool kv[kChan];
    size_t wbase[kChan];
#pragma unroll
    for (int q = 0; q < kChan; ++q) {
      kin[q] = kc * 32 * kChan + q * 32 + lane;
      kv[q] = kin[q] < a.K;
      const int kb = kv[q] ? kin[q] / a.Kb : 0;
      wbase[q] = kv[q] ? (size_t)((grp * a.nkb + kb) * a.ncb) * tile_elems
                             + kin[q] % a.Kb
                       : 0;
    }

    float acc[kPix][kChan];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int q = 0; q < kChan; ++q) acc[p][q] = 0.f;

    for (int di = 0; di < a.r; ++di) {
      for (int dj = 0; dj < a.r; ++dj) {
        const float* xp[kPix];
        bool ok[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const int iy = py[p] * a.s - a.pad_h + di;
          const int ix = px[p] * a.s - a.pad_w + dj;
          ok[p] = pv[p] && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
          xp[p] = ok[p] ? x + (((size_t)b * a.H + iy) * a.W + ix) * a.Ct
                              + grp * a.C
                        : x;
        }
        const size_t tap_off = (size_t)(di * a.r + dj) * a.Cb * a.Kb;
        for (int cb = 0; cb < a.ncb; ++cb) {
          const int c0 = cb * a.Cb;
          const int cend = min(a.Cb, a.C - c0);
          const float* wt = slab + (size_t)cb * tile_elems + tap_off;
          for (int cc = 0; cc < cend; ++cc) {
            float xv[kPix];
#pragma unroll
            for (int p = 0; p < kPix; ++p)
              xv[p] = ok[p] ? __ldg(xp[p] + c0 + cc) : 0.f;
#pragma unroll
            for (int q = 0; q < kChan; ++q) {
              const float wv =
                  kv[q] ? __ldg(wt + wbase[q] + (size_t)cc * a.Kb) : 0.f;
#pragma unroll
              for (int p = 0; p < kPix; ++p)
                acc[p][q] = fmaf(xv[p], wv, acc[p][q]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (!pv[p]) continue;
      const int pix = pg * kPix + p;
#pragma unroll
      for (int q = 0; q < kChan; ++q) {
        if (!kv[q]) continue;
        const int k = grp * a.K + kin[q];
        ytile[pix * kf + k] = bias_relu(acc[p][q], bias[k], a.relu);
      }
    }
  }
  __syncthreads();
  fused_epilogue(ytile, ct, kf, 0, b, pi0, pj0, a, out);
}

}  // namespace

extern "C" int repro_conv_direct(const ConvArgs* args, const float* x,
                                 const float* slab, const float* bias,
                                 float* out, cudaStream_t stream) {
  const ConvArgs a = *args;
  const int ct = a.ps * (a.PT - 1) + a.pwin;
  const size_t smem = (size_t)ct * ct * a.g * a.K * sizeof(float);
  if (a.PT < 1 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nph = (a.ph_out + a.PT - 1) / a.PT;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  dim3 grid(nph * npw, a.B);
  conv_direct_kernel<<<grid, kThreads, smem, stream>>>(a, x, slab, bias,
                                                       out);
  return (int)cudaGetLastError();
}
