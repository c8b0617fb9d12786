// Strided direct conv layer: conv + bias + ReLU, then cross-channel LRN and
// VALID max-pool, for any filter size, stride, groups and padding.
//
// Replaces the TPU kernel _direct_kernel (src/repro/kernels/conv/direct.py,
// launched by conv2d_direct): AlexNet conv1 (11x11 stride 4, 3 -> 96) and
// conv2 (5x5, groups 2, 96 -> 256), both with LRN and a 3/2 pool.
//
// What bounds it on an H100: operations.  conv2 at batch 8 is 1.8 G
// multiply-adds against 5 MB of input, weights and output; conv1 is
// 0.84 G against 7 MB.  The results are plain FP32 (no TF32), so the roof
// is the 67 TFLOP/s of the FMA pipes, and the design is a register-tiled
// FP32 GEMM that keeps those pipes fed from shared memory.
//
// Design.  Two launches.
// 1. The conv stage is an implicit GEMM per group: rows M are the conv
//    pixels (b, oy, ox), columns N the group's K output channels, and the
//    reduction runs over the r*r*C taps in the order (di, dj, c), c
//    fastest.  A block of 256 threads owns a BM x BN tile of one group
//    and walks the reduction in chunks of 16
//    through a 3-stage cp.async ring in shared memory: A is an im2col
//    gather from NHWC x (4-byte copies, or 16-byte ones where C is a
//    multiple of 4; taps outside the input are zero-filled by the copy),
//    B the packed slab's rows (tile lin = k * ncb + c of (r, r, Cb, Kb);
//    16-byte copies where Kb is a multiple of 4).  A per-block table in
//    shared memory maps each reduction index to its (di, dj, c) and slab
//    offset, so the gather does no division.  Each thread holds a
//    (BM / 16) x (BN / 16) register tile and reads shared memory as float4
//    (float2 for 96 columns); a warp's reads take one wavefront each.
//    The default tile is 64 x BN, BN = 64 or 96, whichever pads K less
//    (conv1 379 blocks of 64 x 96, conv2 368 of 64 x 64; three blocks an
//    SM, so either is one wave of the 132 SMs).  The launcher is also
//    built for 64 x 128, 128 x 64 and 128 x 96 tiles (two blocks an SM,
//    16-byte slab copies only), which the measured autotuner
//    (core/autotune.py) may pick per layer.  Bias
//    and ReLU (epilogue.cuh) are applied in registers and y (B, out_h,
//    out_w, g*K) is written once; it stays in the 50 MB L2 for the second
//    launch, as the TPU kernel kept y in VMEM.  Where one tile holds all
//    of a pixel's channels (one group, K <= BN: conv1), the block first
//    puts its tile in shared memory and applies the LRN there, once per
//    pixel and channel.
// 2. The epilogue stage runs LRN across all g*K channels (the group seam
//    included; conv2) where the conv stage did not, and the max-pool, from
//    y (epilogue.cuh's fused_epilogue), and writes only the pooled map.
//    With no pool and no LRN left to apply the conv stage writes the
//    output and this launch is skipped.
// ABFT (the armed instantiation, ConvArgs.verdict set): the slab carries
// a checksum row after each tile's Cb rows of a tap (row stride Cs = Cb +
// 1), and every conv-stage block checks its share of the whole slab
// (abft.cuh) while its cp.async ring fills, adding the mismatched lanes to
// the verdict.  The GEMM reads the same Cb rows either way, so armed and
// unarmed outputs are bit-equal.
// bf16 (ConvArgs.xdt = sdt = kBf16, the reference's bf16 model: bf16
// activations, slab and bias): the conv stage's own instantiation loads x
// and the slab with plain 2-byte loads, widened to f32 as they are stored
// into the same f32 rings (no cp.async: it cannot widen), so the GEMM,
// the bias, ReLU, LRN and pool run on exactly the f32 values of the
// widened inputs; y stays f32, and only the final store rounds to bf16.
// So the bf16 kernel is bit-equal to the f32 kernel on the widened inputs
// with its output rounded to bf16, at every block tile.
// Numerics: each output is one thread's fmaf chain from +0 over (di, dj,
// c) in ascending order; zero-filled taps (padding, the ragged reduction
// tail) are FMA'd, not skipped, so a NaN weight poisons as in the plain
// version.  No TF32, no atomics, no split-K: the result is deterministic
// and does not depend on the tiling or the slab's blocking, so the block
// tile is a knob that cannot change the bits.  The LRN takes the same
// values and calls the same lrn_at in either stage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "abft.cuh"
#include "conv_args.cuh"
#include "cp_async.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads over a block tile
constexpr int kBK = 16;          // reduction chunk
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kApad = kBK + 4;   // A row stride in shared memory (floats)

// Shared memory of one conv-stage block of BM = 16 tm rows and BN = 16 tn
// columns: the A and B rings (which also hold the BM x BN conv tile for an
// LRN in this stage), the two per-reduction-index tables and, armed, the
// ABFT partial sums.
size_t gemm_smem_bytes(int tm, int tn, int R, bool armed) {
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
// (abft.cuh); T: the element type of x, the slab and the bias (bf16: plain
// widening loads, VA = VB = false).  y is the f32 conv map, or, with
// narrow set (bf16, no epilogue launch after), the bf16 output.  The
// default tiles are held to 80 registers, so three blocks share an SM and
// a grid of up to 396 blocks fills one wave.
template <int TM, int TN, bool VA, bool VB, bool ARMED, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks(TM, TN))
conv_direct_gemm(ConvArgs a, const T* __restrict__ x,
                 const T* __restrict__ slab, const T* __restrict__ bias,
                 void* __restrict__ y, int narrow) {
  constexpr bool kF32In = std::is_same<T, float>::value;
  static_assert(kF32In || (!VA && !VB), "cp.async copies f32 only");
  using Word = typename std::conditional<sizeof(T) == 4, unsigned,
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
      const T* src = ok ? slab + wcol[j] + wrow[k] : slab;
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

// Grid (pooled tiles of PT x PT, B): LRN + max-pool from y in global memory.
__global__ void __launch_bounds__(kThreads)
conv_direct_epilogue(ConvArgs a, const float* __restrict__ y,
                     void* __restrict__ out) {
  fused_epilogue(a, y, out);
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

template <int TM, int TN, bool VA, bool VB, bool ARMED, typename T = float>
cudaError_t launch_gemm(const ConvArgs& a, size_t smem, cudaStream_t stream,
                        const GemmPtrs& p) {
  auto kernel = conv_direct_gemm<TM, TN, VA, VB, ARMED, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int M = a.B * a.out_h * a.out_w;
  dim3 grid((M + 16 * TM - 1) / (16 * TM), (a.K + 16 * TN - 1) / (16 * TN),
            a.g);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, static_cast<const T*>(p.x), static_cast<const T*>(p.slab),
      static_cast<const T*>(p.bias), p.y, p.narrow);
  return cudaGetLastError();
}

// ANY_SLAB: built for 4-byte slab copies too (the default tiles); the
// other tiles take 16-byte ones only and refuse a slab without them.  A
// bf16 launch has its own instantiation (widening loads) at every tile.
template <int TM, int TN, bool ARMED, bool ANY_SLAB>
cudaError_t launch_tile(const ConvArgs& a, size_t smem, bool va, bool vb,
                        cudaStream_t stream, const GemmPtrs& p) {
  if (a.xdt == kBf16)
    return launch_gemm<TM, TN, false, false, ARMED, __nv_bfloat16>(
        a, smem, stream, p);
  if (va && vb)
    return launch_gemm<TM, TN, true, true, ARMED>(a, smem, stream, p);
  if (vb)
    return launch_gemm<TM, TN, false, true, ARMED>(a, smem, stream, p);
  if constexpr (ANY_SLAB) {
    if (va)
      return launch_gemm<TM, TN, true, false, ARMED>(a, smem, stream, p);
    return launch_gemm<TM, TN, false, false, ARMED>(a, smem, stream, p);
  }
  return cudaErrorInvalidValue;
}

template <int TM, int TN, bool ANY_SLAB>
cudaError_t launch_armed(const ConvArgs& a, size_t smem, bool va, bool vb,
                         cudaStream_t stream, const GemmPtrs& p) {
  return a.verdict
             ? launch_tile<TM, TN, true, ANY_SLAB>(a, smem, va, vb, stream, p)
             : launch_tile<TM, TN, false, ANY_SLAB>(a, smem, va, vb, stream,
                                                    p);
}

// Whether the conv stage is built for this tile (rows and columns per
// thread) and slab: the default tiles for any slab, the others for 16-byte
// slab copies (kernels/conv/direct.py's TILES and ANY_SLAB_TILES).
bool built_for(int tm, int tn, bool vb) {
  return (tm == 4 && (tn == 4 || tn == 6))
         || (vb && ((tm == 4 && tn == 8)
                    || (tm == 8 && (tn == 4 || tn == 6))));
}

cudaError_t launch_conv_stage(int tm, int tn, const ConvArgs& a, size_t smem,
                              bool va, bool vb, cudaStream_t stream,
                              const GemmPtrs& p) {
  if (tm == 4 && tn == 4)
    return launch_armed<4, 4, true>(a, smem, va, vb, stream, p);
  if (tm == 4 && tn == 6)
    return launch_armed<4, 6, true>(a, smem, va, vb, stream, p);
  if (tm == 4 && tn == 8)
    return launch_armed<4, 8, false>(a, smem, va, vb, stream, p);
  if (tm == 8 && tn == 4)
    return launch_armed<8, 4, false>(a, smem, va, vb, stream, p);
  if (tm == 8 && tn == 6)
    return launch_armed<8, 6, false>(a, smem, va, vb, stream, p);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, bias and out in args->xdt's element type, the slab in args->sdt's
// (the same: f32 or bf16); y: (B, out_h, out_w, g*K) f32 scratch for the
// epilogue stage (unused, and may equal out, when there is no pool and no
// LRN left to apply); tm, tn: rows and columns per thread of the conv
// stage's 16 tm x 16 tn block tile (the default tiles are 4 x 4 and 4 x
// 6).  Armed (args->verdict set, args->Cs = Cb + 1), the conv stage also
// adds the slab's mismatched checksum lanes to *args->verdict.
extern "C" int repro_conv_direct(const ConvArgs* args, const void* x,
                                 const void* slab, const void* bias,
                                 float* y, void* out, int tm, int tn,
                                 cudaStream_t stream) {
  const ConvArgs a = *args;
  const int R = a.r * a.r * a.C;
  const size_t smem = gemm_smem_bytes(tm, tn, R, a.verdict != nullptr);
  const size_t slab_elems =
      (size_t)a.g * a.nkb * a.ncb * a.r * a.r * a.Cs * a.Kb;
  const bool bf16 = a.xdt == kBf16;
  const bool va = !bf16 && a.C % 4 == 0 && (uintptr_t)x % 16 == 0;
  // a bf16 launch has every tile the f32 one has for its slab's Kb
  const bool vb = a.Kb % 4 == 0 && (bf16 || (uintptr_t)slab % 16 == 0);
  if ((a.xdt != kF32 && a.xdt != kBf16) || a.sdt != a.xdt
      || !built_for(tm, tn, vb) || a.r > 127 || a.C > 0xffff
      || slab_elems >= (1u << 31) || smem > 227 * 1024 || a.PT < 1
      || a.Cs != a.Cb + (a.verdict ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  // the epilogue stage: the pool, and the LRN where the conv stage cannot
  // apply it (it then pools the LRN'd map)
  ConvArgs ea = a;
  if (lrn_in_gemm(a, 16 * tn)) ea.lrn_n = 0;
  const bool epilogue = ea.lrn_n || a.pwin != 1 || a.ps != 1;
  const GemmPtrs p{x, slab, bias, epilogue ? (void*)y : out,
                   bf16 && !epilogue};
  const cudaError_t err =
      launch_conv_stage(tm, tn, a, smem, va, vb, stream, p);
  if (err != cudaSuccess || !epilogue) return (int)err;
  const int nph = (a.ph_out + a.PT - 1) / a.PT;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  conv_direct_epilogue<<<dim3(nph * npw, a.B), kThreads, 0, stream>>>(
      ea, y, out);
  return (int)cudaGetLastError();
}
