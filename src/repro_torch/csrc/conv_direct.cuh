// The conv stage of the direct conv layer (conv_direct.cu, whose head
// comment describes the design): the FFMA kernel template, its launch
// geometry and launcher, shared by the f32 instantiations in
// conv_direct.cu and the bf16-x / f32-slab ones in conv_direct_bf16.cu;
// and the geometry and launcher of the bf16 tensor-core route
// (conv_direct_bf16.cu), which conv_direct.cu's C entry point dispatches
// to.  Two translation units, so that nvcc builds them side by side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "abft.cuh"
#include "conv_args.cuh"
#include "cp_async.cuh"
#include "epilogue.cuh"

namespace conv_direct_impl {


constexpr int kThreads = 256;    // 16 x 16 threads over a block tile
constexpr int kBK = 16;          // reduction chunk
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kApad = kBK + 4;   // A row stride in shared memory (floats)

// Shared memory of one conv-stage block of BM = 16 tm rows and BN = 16 tn
// columns: the A and B rings (which also hold the BM x BN conv tile for an
// LRN in this stage), the two per-reduction-index tables and, armed, the
// ABFT partial sums.
inline size_t gemm_smem_bytes(int tm, int tn, int R, bool armed) {
  return ((size_t)kStages * (16 * tm * kApad + kBK * 16 * tn)
          + 2 * (size_t)R + (armed ? kAbftSmemInts : 0)) * sizeof(float);
}

// Blocks an SM the register budget is set for: three for the default
// tiles (80 registers), two for the larger ones (128).
__host__ __device__ constexpr int min_blocks(int tm, int tn) {
  return tm * tn > 24 ? 2 : 3;
}

// Whether the conv stage applies the LRN itself: one block tile holds all
// of a pixel's channels (one group, K <= BN).
__host__ __device__ __forceinline__ bool lrn_in_gemm(const ConvArgs& a,
                                                     int bn) {
  return a.lrn_n && a.g == 1 && a.K <= bn;
}

// Grid (ceil(M / BM), ceil(K / BN), g), BM = 16 TM, BN = 16 TN.  VA / VB:
// 16-byte copies of A / B; ARMED: check the slab's checksum rows
// (abft.cuh); T: the element type of x and the bias, S the slab's: f32
// and f32, or bf16 x with an f32 (conv_bfp) slab, whose x this kernel
// loads with plain 2-byte loads widened to f32 (VA = false; cp.async
// cannot widen).  A bf16 slab takes the tensor-core route of
// conv_direct_bf16.cu instead, never this kernel.  y is the f32 conv
// map, or, with narrow set (bf16 x, no epilogue launch after), the bf16
// output.  The default tiles are held to 80 registers, so three blocks
// share an SM and a grid of up to 396 blocks fills one wave.
template <int TM, int TN, bool VA, bool VB, bool ARMED, typename T,
          typename S>
__global__ void __launch_bounds__(kThreads, min_blocks(TM, TN))
conv_direct_gemm(ConvArgs a, const T* __restrict__ x,
                 const S* __restrict__ slab, const T* __restrict__ bias,
                 void* __restrict__ y, int narrow) {
  constexpr bool kF32In = std::is_same<T, float>::value;
  static_assert(kF32In || (!VA && !VB), "cp.async copies f32 only");
  static_assert(std::is_same<S, float>::value,
                "an f32 slab (a bf16 one takes the tensor-core route)");
  using Word = typename std::conditional<sizeof(S) == 4, unsigned,
                                         unsigned short>::type;
  const bool nar = !kF32In && narrow;
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  static_assert(BM * kBK / (VA ? 4 : 1) % kThreads == 0,
                "every thread makes the same number of A copies");
  static_assert(BM * BN <= kStages * (BM * kApad + kBK * BN),
                "the rings hold the conv tile of an LRN in this stage");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                               // kStages x BM x kApad
  float* Bs = As + kStages * BM * kApad;          // kStages x kBK x BN
  const int R = a.r * a.r * a.C;
  int* xtap = (int*)(Bs + kStages * kBK * BN);    // (di << 24 | dj << 16 | c)
  int* wrow = xtap + R;                           // slab offset of row k
  const int M = a.B * a.out_h * a.out_w;
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const size_t tile_elems = (size_t)a.r * a.r * a.Cs * a.Kb;

  for (int k = t; k < R; k += kThreads) {
    const int c = k % a.C, tap = k / a.C;
    xtap[k] = ((tap / a.r) << 24) | ((tap % a.r) << 16) | c;
    wrow[k] = (int)((c / a.Cb) * tile_elems
                    + ((size_t)tap * a.Cs + c % a.Cb) * a.Kb);
  }

  // the A row this thread gathers: one conv pixel for the whole reduction
  const int arow = t % BM;
  const int m = m0 + arow;
  const bool mvalid = m < M;
  const int hw = a.out_h * a.out_w;
  const int mb = mvalid ? m / hw : 0, mr = mvalid ? m % hw : 0;
  const int iy0 = (mr / a.out_w) * a.s - a.pad_h;
  const int ix0 = (mr % a.out_w) * a.s - a.pad_w;
  const T* xb = x + (size_t)mb * a.H * a.W * a.Ct + grp * a.C;
  // the B copies this thread makes each chunk: row kk, column col of the
  // tile, from slab + wcol + wrow[k] (wcol < 0: a column past K)
  constexpr int kRow = VB ? BN / 4 : BN;          // copies a B row takes
  constexpr int kBPer = (kBK * kRow + kThreads - 1) / kThreads;
  int bkk[kBPer], bcol[kBPer];
  long long wcol[kBPer];
#pragma unroll
  for (int j = 0; j < kBPer; ++j) {
    const int q = t + kThreads * j;
    bkk[j] = q < kBK * kRow ? q / kRow : kBK;     // kBK: no copy
    bcol[j] = (VB ? 4 : 1) * (q % kRow);
    const int n = n0 + bcol[j];
    wcol[j] = n < a.K ? (long long)(((size_t)grp * a.nkb + n / a.Kb) * a.ncb
                                    * tile_elems + n % a.Kb)
                      : -1;
  }
  __syncthreads();

  auto load_chunk = [&](int stage, int k0) {
    float* as = As + stage * BM * kApad + arow * kApad;
    constexpr int kAPer = BM * kBK / (VA ? 4 : 1) / kThreads;
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int kk = (VA ? 4 : 1) * (t / BM + (kThreads / BM) * j);
      const int k = k0 + kk;
      const int v = k < R ? xtap[k] : 0;
      const int iy = iy0 + (v >> 24), ix = ix0 + ((v >> 16) & 255);
      const bool ok = mvalid && k < R && iy >= 0 && iy < a.H && ix >= 0
                      && ix < a.W;
      const T* src =
          ok ? xb + ((size_t)iy * a.W + ix) * a.Ct + (v & 0xffff) : x;
      if constexpr (!kF32In) as[kk] = ok ? widen(*src) : 0.f;
      else if (VA) cp_async16(as + kk, src, ok);
      else cp_async4(as + kk, src, ok);
    }
    float* bs = Bs + stage * kBK * BN;
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      if (bkk[j] == kBK) continue;
      const int k = k0 + bkk[j];
      const bool ok = k < R && wcol[j] >= 0;
      const S* src = ok ? slab + wcol[j] + wrow[k] : slab;
      if constexpr (!kF32In) bs[bkk[j] * BN + bcol[j]] = ok ? widen(*src)
                                                           : 0.f;
      else if (VB) cp_async16(bs + bkk[j] * BN + bcol[j], src, ok);
      else cp_async4(bs + bkk[j] * BN + bcol[j], src, ok);
    }
  };

  const int nchunks = (R + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, s * kBK);
    cp_async_commit();
  }
  if constexpr (ARMED)          // its partial sums after the two tables
    abft_check_slab<Word>(a, a.r * a.r, slab, (unsigned*)(wrow + R));

  // thread (tm, tn) of the 16 x 16 owns rows tm + 16 i and columns
  // tn * TN + j of the tile; a warp spans 4 tm x 8 tn, so its float4 reads
  // of A (4 rows, 80 bytes apart) and of B (8 neighbours) each take one
  // shared-memory wavefront
  const int tm = (t / 64) * 4 + (t % 32) / 8;
  const int tn = ((t / 32) % 2) * 8 + t % 8;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kc + kStages - 1;
    if (nxt < nchunks) load_chunk(nxt % kStages, nxt * kBK);
    cp_async_commit();
    const float* as = As + (kc % kStages) * BM * kApad + tm * kApad;
    const float* bs = Bs + (kc % kStages) * kBK * BN + tn * TN;
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float b[4][TN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* bp = bs + (kq + kk) * BN;
        if constexpr (TN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(bp + j);
            b[kk][j] = v.x, b[kk][j + 1] = v.y, b[kk][j + 2] = v.z,
            b[kk][j + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; j += 2) {
            const float2 v = *reinterpret_cast<const float2*>(bp + j);
            b[kk][j] = v.x, b[kk][j + 1] = v.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av =
            *reinterpret_cast<const float4*>(as + 16 * i * kApad + kq);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(ak[kk], b[kk][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const int kf = a.g * a.K;
  const int nt0 = n0 + tn * TN;
  if (lrn_in_gemm(a, BN)) {
    // the block's conv tile (BM pixels x K channels) in the rings' place,
    // then LRN across its channels, once per pixel and channel
    __syncthreads();
    float* yt = smem;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (nt0 + j < a.K)
          yt[(tm + 16 * i) * BN + tn * TN + j] =
              bias_relu(acc[i][j], widen(bias[nt0 + j]), a.relu);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int mo = m0 + tm + 16 * i;
      if (mo >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (nt0 + j < a.K)
          store_out(y, (size_t)mo * kf + nt0 + j,
                    lrn_at(yt + (tm + 16 * i) * BN, nt0 + j, a.K, a), nar);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mo = m0 + tm + 16 * i;
    if (mo >= M) continue;
    const size_t yo = (size_t)mo * kf + grp * a.K + nt0;
    const T* bp = bias + grp * a.K + nt0;
    if constexpr (TN % 4 == 0 && kF32In) {
      float* yp = static_cast<float*>(y) + yo;
      if (a.K % 4 == 0) {                   // whole float4s, all in range
#pragma unroll
        for (int j = 0; j < TN; j += 4)
          if (nt0 + j < a.K)
            *reinterpret_cast<float4*>(yp + j) = make_float4(
                bias_relu(acc[i][j], bp[j], a.relu),
                bias_relu(acc[i][j + 1], bp[j + 1], a.relu),
                bias_relu(acc[i][j + 2], bp[j + 2], a.relu),
                bias_relu(acc[i][j + 3], bp[j + 3], a.relu));
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (nt0 + j < a.K)
        store_out(y, yo + j, bias_relu(acc[i][j], widen(bp[j]), a.relu),
                  nar);
  }
}

// The conv stage's raw pointers: x, slab and bias in the launch's element
// type, y the f32 conv map or (narrow) the bf16 output.
struct GemmPtrs {
  const void* x;
  const void* slab;
  const void* bias;
  void* y;
  int narrow;
};

template <int TM, int TN, bool VA, bool VB, bool ARMED, typename T = float,
          typename S = T>
cudaError_t launch_gemm(const ConvArgs& a, size_t smem, cudaStream_t stream,
                        const GemmPtrs& p) {
  auto kernel = conv_direct_gemm<TM, TN, VA, VB, ARMED, T, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int M = a.B * a.out_h * a.out_w;
  dim3 grid((M + 16 * TM - 1) / (16 * TM), (a.K + 16 * TN - 1) / (16 * TN),
            a.g);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, static_cast<const T*>(p.x), static_cast<const S*>(p.slab),
      static_cast<const T*>(p.bias), p.y, p.narrow);
  return cudaGetLastError();
}

// The FFMA conv stage with bf16 x and bias on an f32 (conv_bfp) slab
// (conv_direct_bf16.cu), armed or not (args.verdict), at tile tm x tn of
// conv_direct.cu's built_for.
cudaError_t launch_conv_stage_bf16(int tm, int tn, const ConvArgs& a,
                                   size_t smem, cudaStream_t stream,
                                   const GemmPtrs& p);

// The bf16 tensor-core conv stage (conv_direct_bf16.cu: bf16 x, bias and
// slab).  A block of BM / 32 x 2 warps owns a BM x BN tile; its ring holds
// kMmaStages k-steps of 16 reduction indices, A rows padded to 24 bf16
// and B rows to BN + 8, so that ldmatrix reads them without bank
// conflicts.
constexpr int kMmaStages = 4;
constexpr int kMmaApad = kBK + 8;
constexpr int kMmaBpad = 8;

__host__ __device__ constexpr int mma_threads(int bm) { return 2 * bm; }

// Shared memory of one tensor-core block: the bf16 rings, or the f32 BM x
// BN conv tile of an LRN in this stage where that is larger (it takes
// the rings' place after the loop), then the per-reduction-index tables
// (two ints a reduction index, one a column) and, armed, the ABFT
// partial sums (one int a thread).
inline size_t mma_smem_bytes(int bm, int bn, int R, bool armed) {
  const size_t ring = (size_t)kMmaStages
                      * (bm * kMmaApad + kBK * (bn + kMmaBpad)) * 2;
  const size_t tile = (size_t)bm * bn * sizeof(float);
  return (ring > tile ? ring : tile)
         + (2 * (size_t)R + bn + (armed ? mma_threads(bm) : 0))
               * sizeof(int);
}

// The tensor-core route's block tiles (kernels/conv/direct.py's
// MMA_TILES), each built for 16-byte copies and for 2-byte loads of x and
// of the slab, so any slab and any x.
inline bool mma_built_for(int bm, int bn) {
  return (bm == 64 && (bn == 64 || bn == 96 || bn == 128))
         || (bm == 128 && bn == 128);
}

// VA: 16-byte cp.async copies of x (C % 8 == 0, x 16-byte aligned), else
// 2-byte loads staged through registers; VB the same for the slab (Kb % 8
// == 0, the slab 16-byte aligned).
cudaError_t launch_conv_stage_mma(int bm, int bn, const ConvArgs& a,
                                  size_t smem, bool va, bool vb,
                                  cudaStream_t stream, const GemmPtrs& p);

}  // namespace conv_direct_impl
