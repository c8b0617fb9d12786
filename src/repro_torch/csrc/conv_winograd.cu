// F(4,3) x F(4,3) Winograd conv layers, stride 1, SAME or VALID, groups:
//   repro_conv_winograd        conv + bias + ReLU
//   repro_conv_winograd_fused  the same, then cross-channel LRN and/or
//                              VALID max-pool (epilogue.cuh)
//
// Replace the TPU kernels _conv2d_kernel (unfused branch of
// conv2d_winograd) and _conv2d_fused_kernel (_conv2d_fused_call) in
// src/repro/kernels/conv/winograd.py: AlexNet conv3 (13x13, 256 -> 384),
// conv4 (384 -> 384, groups 2) and conv5 (384 -> 256, groups 2, 3/2 pool).
//
// What bounds them on an H100: operations.  conv3 at batch 8 is 0.45 G
// Winograd-domain multiply-adds (plus the transforms) against 18 MB of
// input, transformed weights and output, about 50 multiply-adds a byte;
// FP32 FMA without tensor cores peaks at 67 TFLOP/s.
//
// Design.  The TPU kernels cut 6x6 tiles from a VMEM-resident plane and ran
// 36 (tiles x Cb) @ (Cb x Kb) GEMMs per grid step, carrying the sums over
// channel blocks in scratch across sequential grid steps.  Here a thread
// block owns up to 8 Winograd tiles of one image and loops over all input
// channels itself, in chunks of 32: the chunk's tiles are loaded (zeros
// outside the image) and transformed (B^T d B) into shared memory, then
// each thread -- one tile x one output channel, lanes on neighbouring
// channels so reads of the transformed slab are coalesced along Kb --
// accumulates its 36 Winograd-domain sums in registers.  After the last
// chunk it applies A^T m A, the bias and ReLU.  The unfused kernel writes
// the 4x4 outputs; the fused kernel owns one image x PT x PT pooled outputs,
// covers their conv tile (ps*(PT-1)+pwin square, conv5: 7x7) with tiles,
// keeps it in shared memory, and runs the shared LRN/pool epilogue.  With
// LRN the block keeps all g*K channels (the window crosses group seams);
// with pool only it keeps one 32*(8/NT)-channel slice, so more blocks run.
// Plain FP32 FMA throughout (no TF32, no atomics): deterministic.  The slab
// is read in the packed layout (tile lin = k * ncb + c of (6, 6, Cb, Kb));
// only the C real channels and K real outputs of a group are read, so the
// channel pad and conv4's K pad (192 -> 256) are never touched.  The
// transform matrices are the reference's (winograd_transform(4, 3)),
// passed in by the host.
#include <cuda_runtime.h>

#include "conv_args.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = kThreads / 32;   // tile slots: one per warp
constexpr int kCc = 32;                 // input channels per chunk
constexpr int kN = 6, kM = 4, kNP = kN * kN;
// Floats of transformed input per channel in U: kNP positions x kSlots
// tiles, plus one so the 32 channels a warp stores land in 32 banks.
constexpr int kUStride = kNP * kSlots + 1;

struct WinoMats {
  float bt[kN * kN];                    // B^T (6, 6)
  float at[kM * kN];                    // A^T (4, 6)
};

// One pass: the block's nt tiles (conv-output origins oy[t], ox[t]) x one
// output channel per thread.  Thread slot = warp: tile slot % nt, channel
// kin = kbase + (slot / nt) * 32 + lane; active threads return their 36
// Winograd-domain sums in acc.  U is kCc * kUStride floats of shared
// memory.  Every thread of the block must call this.
__device__ __forceinline__ void wino_pass(const ConvArgs& a, const WinoMats& mt,
                          const float* __restrict__ x,
                          const float* __restrict__ slab, int b, int grp,
                          int nt, const int* oy, const int* ox, int kin,
                          bool active, float* U, float acc[kNP]) {
#pragma unroll
  for (int i = 0; i < kNP; ++i) acc[i] = 0.f;
  const int t = (threadIdx.x >> 5) % nt;
  const int kb = active ? kin / a.Kb : 0;
  const size_t kofs = active ? kin % a.Kb : 0;
  const size_t tile_elems = (size_t)kNP * a.Cb * a.Kb;
  for (int c0 = 0; c0 < a.C; c0 += kCc) {
    __syncthreads();                    // U is free
    for (int idx = threadIdx.x; idx < nt * kCc; idx += blockDim.x) {
      const int tt = idx / kCc, c = idx % kCc, cabs = c0 + c;
      const int iy0 = oy[tt] - a.pad_h, ix0 = ox[tt] - a.pad_w;
      float d[kN][kN];
#pragma unroll
      for (int u = 0; u < kN; ++u)
#pragma unroll
        for (int v = 0; v < kN; ++v) {
          const int iy = iy0 + u, ix = ix0 + v;
          d[u][v] = (cabs < a.C && iy >= 0 && iy < a.H && ix >= 0 &&
                     ix < a.W)
                        ? __ldg(x + (((size_t)b * a.H + iy) * a.W + ix) * a.Ct
                                + grp * a.C + cabs)
                        : 0.f;
        }
      float tmp[kN][kN];
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int v = 0; v < kN; ++v) {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < kN; ++u) s = fmaf(mt.bt[i * kN + u], d[u][v], s);
          tmp[i][v] = s;
        }
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < kN; ++v) s = fmaf(tmp[i][v], mt.bt[j * kN + v], s);
          U[c * kUStride + (i * kN + j) * kSlots + tt] = s;
        }
    }
    __syncthreads();
    if (!active) continue;
    const int ccount = min(kCc, a.C - c0);
    for (int c = 0; c < ccount; ++c) {
      const int cabs = c0 + c, cb = cabs / a.Cb;
      const float* vp = slab
          + (size_t)((grp * a.nkb + kb) * a.ncb + cb) * tile_elems
          + (size_t)(cabs - cb * a.Cb) * a.Kb + kofs;
      const float* up = U + c * kUStride + t;
#pragma unroll
      for (int pos = 0; pos < kNP; ++pos)
        acc[pos] = fmaf(up[pos * kSlots],
                        __ldg(vp + (size_t)pos * a.Cb * a.Kb), acc[pos]);
    }
  }
}

// y = A^T m A: (6, 6) Winograd-domain sums -> (4, 4) outputs.
__device__ __forceinline__ void wino_inverse(const WinoMats& mt,
                                             const float m[kNP],
                                             float y[kM][kM]) {
  float tmp[kM][kN];
#pragma unroll
  for (int p = 0; p < kM; ++p)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) s = fmaf(mt.at[p * kN + i], m[i * kN + j], s);
      tmp[p][j] = s;
    }
#pragma unroll
  for (int p = 0; p < kM; ++p)
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) s = fmaf(tmp[p][j], mt.at[q * kN + j], s);
      y[p][q] = s;
    }
}

// Grid (tile groups of kSlots tiles, B, g * ceil(K / 32)).
__global__ void __launch_bounds__(kThreads)
conv_winograd_kernel(ConvArgs a, WinoMats mt, const float* __restrict__ x,
                     const float* __restrict__ slab,
                     const float* __restrict__ bias,
                     float* __restrict__ out) {
  extern __shared__ float U[];
  __shared__ int oy[kSlots], ox[kSlots];
  const int tw = (a.out_w + kM - 1) / kM;
  const int ntiles = ((a.out_h + kM - 1) / kM) * tw;
  const int t0 = blockIdx.x * kSlots;
  const int nt = min(kSlots, ntiles - t0);
  const int b = blockIdx.y;
  const int nkc = (a.K + 31) / 32;
  const int grp = blockIdx.z / nkc;
  const int warp = threadIdx.x >> 5;
  const int kin = (blockIdx.z % nkc) * 32 + (threadIdx.x & 31);
  if (threadIdx.x < nt) {
    oy[threadIdx.x] = ((t0 + threadIdx.x) / tw) * kM;
    ox[threadIdx.x] = ((t0 + threadIdx.x) % tw) * kM;
  }
  __syncthreads();
  const bool active = warp < nt && kin < a.K;
  float acc[kNP];
  wino_pass(a, mt, x, slab, b, grp, nt, oy, ox, kin, active, U, acc);
  if (!active) return;
  float y[kM][kM];
  wino_inverse(mt, acc, y);
  const int kf = a.g * a.K, k = grp * a.K + kin;
  const float bk = bias[k];
#pragma unroll
  for (int p = 0; p < kM; ++p)
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      const int yy = oy[warp] + p, xx = ox[warp] + q;
      if (yy < a.out_h && xx < a.out_w)
        out[(((size_t)b * a.out_h + yy) * a.out_w + xx) * kf + k] =
            bias_relu(y[p][q], bk, a.relu);
    }
}

// Grid (pooled tiles, B, 1 with LRN else g * ceil(K / pass)).
__global__ void __launch_bounds__(kThreads)
conv_winograd_fused_kernel(ConvArgs a, WinoMats mt,
                           const float* __restrict__ x,
                           const float* __restrict__ slab,
                           const float* __restrict__ bias,
                           float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int oy[kSlots], ox[kSlots];
  const int ct = a.ps * (a.PT - 1) + a.pwin;
  const int ntw = (ct + kM - 1) / kM;
  const int nt = ntw * ntw;
  const int cps = kSlots / nt;          // channel slices per pass
  const int pass = 32 * cps;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  const int pi0 = (blockIdx.x / npw) * a.PT;
  const int pj0 = (blockIdx.x % npw) * a.PT;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int kf = a.g * a.K;
  // channel range of this block: all g*K with LRN, else one pass slice
  int g0 = 0, g1 = a.g, kb0 = 0, kb1 = a.K, kofs = 0, kt = kf;
  if (!a.lrn_n) {
    const int npass = (a.K + pass - 1) / pass;
    g0 = blockIdx.z / npass;
    g1 = g0 + 1;
    kb0 = (blockIdx.z % npass) * pass;
    kb1 = min(kb0 + pass, a.K);
    kofs = g0 * a.K + kb0;
    kt = kb1 - kb0;
  }
  float* ytile = smem;                                   // ct * ct * kt
  float* U = smem + ((ct * ct * kt + 3) & ~3);
  if (threadIdx.x < nt) {
    oy[threadIdx.x] = pi0 * a.ps + (threadIdx.x / ntw) * kM;
    ox[threadIdx.x] = pj0 * a.ps + (threadIdx.x % ntw) * kM;
  }
  __syncthreads();
  const int t = warp % nt;
  for (int grp = g0; grp < g1; ++grp) {
    for (int kbase = kb0; kbase < kb1; kbase += pass) {
      const int kin = kbase + (warp / nt) * 32 + (threadIdx.x & 31);
      const bool active = warp < cps * nt && kin < kb1;
      float acc[kNP];
      wino_pass(a, mt, x, slab, b, grp, nt, oy, ox, kin, active, U, acc);
      if (!active) continue;
      float y[kM][kM];
      wino_inverse(mt, acc, y);
      const int k = grp * a.K + kin;
      const float bk = bias[k];
#pragma unroll
      for (int p = 0; p < kM; ++p)
#pragma unroll
        for (int q = 0; q < kM; ++q) {
          const int ly = (t / ntw) * kM + p, lx = (t % ntw) * kM + q;
          if (ly < ct && lx < ct)
            ytile[(ly * ct + lx) * kt + (k - kofs)] =
                bias_relu(y[p][q], bk, a.relu);
        }
    }
  }
  __syncthreads();
  fused_epilogue(ytile, ct, kt, kofs, b, pi0, pj0, a, out);
}

int load_mats(const float* host, WinoMats* mt) {
  if (host == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kN * kN; ++i) mt->bt[i] = host[i];
  for (int i = 0; i < kM * kN; ++i) mt->at[i] = host[kN * kN + i];
  return 0;
}

}  // namespace

// mats: host array of B^T (6x6) then A^T (4x6), row-major.
extern "C" int repro_conv_winograd(const ConvArgs* args, const float* mats,
                                   const float* x, const float* slab,
                                   const float* bias, float* out,
                                   cudaStream_t stream) {
  const ConvArgs a = *args;
  WinoMats mt;
  if (a.r != 3 || a.s != 1 || load_mats(mats, &mt))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kCc * kUStride * sizeof(float);
  const int ntiles = ((a.out_h + kM - 1) / kM) * ((a.out_w + kM - 1) / kM);
  dim3 grid((ntiles + kSlots - 1) / kSlots, a.B, a.g * ((a.K + 31) / 32));
  conv_winograd_kernel<<<grid, kThreads, smem, stream>>>(a, mt, x, slab,
                                                         bias, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_conv_winograd_fused(const ConvArgs* args,
                                         const float* mats, const float* x,
                                         const float* slab, const float* bias,
                                         float* out, cudaStream_t stream) {
  const ConvArgs a = *args;
  WinoMats mt;
  if (a.r != 3 || a.s != 1 || a.PT < 1 || load_mats(mats, &mt))
    return (int)cudaErrorInvalidValue;
  const int ct = a.ps * (a.PT - 1) + a.pwin;
  const int ntw = (ct + kM - 1) / kM;
  const int nt = ntw * ntw;
  if (nt > kSlots) return (int)cudaErrorInvalidValue;
  const int pass = 32 * (kSlots / nt);
  const int npass = (a.K + pass - 1) / pass;
  const int kt = a.lrn_n ? a.g * a.K : (a.K < pass ? a.K : pass);
  const size_t smem = (((size_t)ct * ct * kt + 3) / 4 * 4
                       + (size_t)kCc * kUStride) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_winograd_fused_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nph = (a.ph_out + a.PT - 1) / a.PT;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  dim3 grid(nph * npw, a.B, a.lrn_n ? 1 : a.g * npass);
  conv_winograd_fused_kernel<<<grid, kThreads, smem, stream>>>(a, mt, x,
                                                               slab, bias,
                                                               out);
  return (int)cudaGetLastError();
}
