// F(m,3) x F(m,3) Winograd conv layer, m = 2..10 (tile n = m + 2 <= 12),
// stride 1, SAME or VALID, groups: conv + bias + ReLU, then (when asked)
// cross-channel LRN and/or VALID max-pool (epilogue.cuh).  One C entry,
// repro_conv_winograd, a layer.
//
// Replaces the TPU kernels _conv2d_kernel (unfused branch of
// conv2d_winograd) and _conv2d_fused_kernel (_conv2d_fused_call) in
// src/repro/kernels/conv/winograd.py: AlexNet conv3 (13x13, 256 -> 384),
// conv4 (384 -> 384, groups 2) and conv5 (384 -> 256, groups 2, 3/2 pool),
// VGG-16's 3x3 layers; the model's ConvSpec.winograd_m picks m (4 by
// default, as in the reference).
//
// What bounds them on an H100: operations.  conv3 at batch 8 is 0.45 G
// Winograd-domain multiply-adds at m = 4 (plus the transforms) against
// 18 MB of input, transformed weights and output, about 50 multiply-adds a
// byte; FP32 FMA without tensor cores peaks at 67 TFLOP/s.
//
// Design.  The TPU kernels ran n^2 (tiles x Cb) @ (Cb x Kb) GEMMs per grid
// step on a VMEM-resident plane.  Here a layer is three launches on the
// caller's stream, four with an LRN or a pool, each stage's output an
// L2-resident scratch the wrapper allocates:
// 1. conv_winograd_input<N>: U = B^T d B once for every Winograd tile of
//    the m-grid (T = B * ceil(out_h/m) * ceil(out_w/m) tiles), group and
//    input channel, zeros outside the image; U is (n^2, g, T, Cu) with the
//    channels contiguous and padded to Cu, a multiple of the GEMM's chunk,
//    with -0.0 (see Numerics).  A thread reads its tile a column of d at a
//    time, so only B^T d (n^2 floats) lives in registers.
// 2. conv_winograd_gemm: the n^2 x g GEMMs M[pos, grp] = U[pos, grp] (T x
//    Cu) @ V[pos, grp] (Cu x K), V read in place from the packed slab
//    (tile lin = k * ncb + c of (n, n, Cb, Kb), Kb contiguous; channels >=
//    C and columns >= K are never read).  The tile size enters only
//    through T and the n^2 positions, both launch arguments: one GEMM
//    serves every m.  A block of 256 threads owns a BM x BN tile of one
//    (position, group) and walks the channels in chunks of 16 through a
//    3-stage cp.async ring (16-byte copies; 4-byte ones for the slab when
//    Kb is not a multiple of 4; a per-block table of each channel's slab
//    row offset, so a copy needs no division); each thread holds a (BM /
//    16) x (BN / 16) register tile read from shared memory as float4
//    (float2 for 32 columns), one wavefront per warp read, as
//    conv_direct.cu's conv stage does.  The default tile is 64 x 64:
//    AlexNet conv3-5 at batch 8 and m = 4 launch 432 / 432 / 288 blocks,
//    one wave at four an SM.  The launcher is also built for 32 x 64, 64 x
//    32 and 128 x 64 tiles (16-byte slab copies only), which the measured
//    autotuner (core/autotune.py) may pick per layer.  M is (n^2, g, T, K).
// 3. conv_winograd_inverse<N>: A^T m A, bias and ReLU per (tile, output
//    channel), into the output, or with an LRN or a pool into the conv
//    map (B, out_h, out_w, g*K).  A thread reads m a column at a time and
//    keeps A^T m (m x n floats); each output is stored as it is made.
// 4. conv_winograd_epilogue (LRN and/or pool only): the LRN across all g*K
//    channels and the max-pool from the conv map (epilogue.cuh's
//    fused_epilogue); writes the pooled map.
// The transform stages are instantiated for n = 4..12 (m = 2..10): the
// per-thread arrays and the fully unrolled transform chains need n at
// compile time, and nine small instantiations a stage cost a few seconds
// of nvcc.  At n = 12 a thread holds 144 floats of B^T d, so the large
// tiles run slower (PERF.md has their times).
// ABFT (ConvArgs.verdict set): the slab carries a checksum row after each
// tile's Cb rows of a Winograd position (row stride Cs = Cb + 1), and the
// armed GEMM instantiation checks its blocks' shares of the whole slab
// (abft.cuh) while their cp.async rings fill, adding the mismatched lanes
// to the verdict.  The GEMMs read the same Cb rows either way, so armed
// and unarmed outputs are bit-equal; one change arms kernels 2 and 3.
// Every tile lies on the m-grid of the plain version, so a Winograd slab
// that is not G w G^T (conv_bfp quantizes it) gives the plain version's
// function.  Every kernel's name holds "conv_winograd": profiles add
// their device time up by that name.
// bf16 (ConvArgs.xdt = kBf16: the reference's bf16 model, bf16 x and
// bias): the slab stays f32, as the reference packs it (G w G^T in f32,
// never cast back, and a conv_bfp slab dequantized to f32; sdt = kF32), so
// only the stages that touch x's element type have a bf16 instantiation:
// the input transform widens x as it loads it and writes U in f32, and the
// inverse transform widens the bias and rounds its output to bf16
// (nearest even) when it writes the layer's output; with an LRN or a pool
// it writes the f32 conv map, and the epilogue launch rounds.  The batched
// GEMM is the f32 one, unchanged.  So the bf16 layer is bit-equal to the
// f32 layer on the widened x and bias with its output rounded to bf16, at
// every block tile.
// Numerics: each stage keeps the roundings of the one-kernel design it
// replaced.  U is B^T d as an fmaf chain from +0 in index order, then
// times B the same way; each Winograd-domain sum is one thread's fmaf
// chain over the group's C real channels in ascending order from +0 (no
// split-K, no TF32, no atomics); the pad channels multiply U's -0.0 by a
// zero-filled weight, and acc + -0.0 is acc bit for bit (+0.0 would turn
// a -0.0 sum into +0.0); the inverse and the bias/ReLU as before.  So the
// result does not depend on the tiling or the slab's blocking, and the
// GEMM's block tile is a knob that cannot change the bits.  The
// transform matrices are the reference's (winograd_transform(m, 3)),
// passed in by the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft.cuh"
#include "conv_args.cuh"
#include "cp_async.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kMaxN = 12, kMinN = 4;   // tile sizes: m = 2..10 at r = 3
constexpr int kThreads = 256;    // GEMM: 16 x 16 threads over a block tile
constexpr int kBK = 16;          // input channels a chunk; U's channel pad
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kApad = kBK + 4;   // A row stride in shared memory (floats)
constexpr int kPointThreads = 128;   // the two transform launches

// B^T (n, n) then A^T (m, n), each row-major with row stride n: sized per
// tile size, so each launch passes only its own (F(4,3): 60 floats)
template <int N>
struct WinoMats {
  float bt[N * N];
  float at[(N - 2) * N];
};

__host__ __device__ __forceinline__ int tiles_w(const ConvArgs& a, int m) {
  return (a.out_w + m - 1) / m;
}

__host__ __device__ __forceinline__ int tiles_per_image(const ConvArgs& a,
                                                        int m) {
  return ((a.out_h + m - 1) / m) * tiles_w(a, m);
}

__host__ __device__ __forceinline__ int u_channels(const ConvArgs& a) {
  return (a.C + kBK - 1) / kBK * kBK;
}

// Grid ceil(T * g * Cu / kPointThreads): one thread a (tile, group,
// channel), channels fastest so loads of x and stores of U coalesce.  XT:
// x's element type (widened to f32 as it is loaded); N: the tile size n,
// m = N - 2 outputs a side.
template <typename XT, int N>
__global__ void __launch_bounds__(kPointThreads)
conv_winograd_input(ConvArgs a, WinoMats<N> mt, const XT* __restrict__ x,
                    float* __restrict__ u) {
  constexpr int M = N - 2, NP = N * N;
  const int cu = u_channels(a);
  const int T = a.B * tiles_per_image(a, M);
  const long long idx = (long long)blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= (long long)T * a.g * cu) return;
  const int c = (int)(idx % cu);
  const int grp = (int)(idx / cu % a.g);
  const int t = (int)(idx / ((long long)cu * a.g));
  const size_t pos_stride = (size_t)a.g * T * cu;
  float* up = u + ((size_t)grp * T + t) * cu + c;
  if (c >= a.C) {
#pragma unroll
    for (int pos = 0; pos < NP; ++pos) up[pos * pos_stride] = -0.f;
    return;
  }
  const int b = t / tiles_per_image(a, M), r = t % tiles_per_image(a, M);
  const int iy0 = (r / tiles_w(a, M)) * M - a.pad_h;
  const int ix0 = (r % tiles_w(a, M)) * M - a.pad_w;
  const XT* xb = x + (size_t)b * a.H * a.W * a.Ct + grp * a.C + c;
  // tmp = B^T d, a column of d at a time
  float tmp[N][N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    float d[N];
    const int ix = ix0 + v;
#pragma unroll
    for (int w = 0; w < N; ++w) {
      const int iy = iy0 + w;
      d[w] = (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
                 ? widen(__ldg(xb + ((size_t)iy * a.W + ix) * a.Ct))
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < N; ++w) s = fmaf(mt.bt[i * N + w], d[w], s);
      tmp[i][v] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < N; ++v) s = fmaf(tmp[i][v], mt.bt[j * N + v], s);
      up[(i * N + j) * pos_stride] = s;
    }
}

// Shared memory of one GEMM block of 16 tm x 16 tn: the rings, one int a
// channel of U (its slab row offset) and, armed, the ABFT partial sums.
size_t gemm_smem_bytes(int tm, int tn, int cu, bool armed) {
  return ((size_t)kStages * (16 * tm * kApad + kBK * 16 * tn) + cu
          + (armed ? kAbftSmemInts : 0)) * sizeof(float);
}

// Blocks an SM the register budget is set for: four (64 registers) up to
// 16 accumulators a thread, else two.
__host__ __device__ constexpr int min_blocks(int tm, int tn) {
  return tm * tn > 16 ? 2 : 4;
}

// Grid (ceil(T / BM), ceil(K / BN), npos * g), BM = 16 TM, BN = 16 TN,
// npos = n^2 Winograd positions and T tiles of the m-grid.  VB:
// 16-byte copies of the slab (Kb a multiple of 4); ARMED: check the slab's
// checksum rows (abft.cuh).  The default 64 x 64 tile is held to 64
// registers, so four blocks share an SM and AlexNet's grids of up to 432
// blocks fill one wave.
template <int TM, int TN, bool VB, bool ARMED>
__global__ void __launch_bounds__(kThreads, min_blocks(TM, TN))
conv_winograd_gemm(ConvArgs a, int T, int npos,
                   const float* __restrict__ u,
                   const float* __restrict__ slab, float* __restrict__ m) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                               // kStages x BM x kApad
  float* Bs = As + kStages * BM * kApad;          // kStages x kBK x BN
  int* crow = (int*)(Bs + kStages * kBK * BN);    // slab offset of channel c
  const int cu = u_channels(a);
  const int pos = blockIdx.z / a.g, grp = blockIdx.z % a.g;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const int tile_elems = npos * a.Cs * a.Kb;

  for (int c = t; c < cu; c += kThreads)           // -1: a pad channel
    crow[c] = c < a.C ? (c / a.Cb) * tile_elems + (c % a.Cb) * a.Kb : -1;

  // the A copies this thread makes each chunk: 4 channels of rows arow +
  // j kARows of the tile (threads past the tile's copies make none)
  constexpr int kACopies = BM * kBK / 4;          // 16-byte copies a chunk
  constexpr int kAPer = (kACopies + kThreads - 1) / kThreads;
  constexpr int kARows = kThreads / (kBK / 4);    // rows a pass of copies
  static_assert(kACopies % kThreads == 0 || kACopies < kThreads,
                "A copies fill whole passes or part of one");
  const bool acopies = kACopies >= kThreads || t < kACopies;
  const int arow = t / (kBK / 4), acol = 4 * (t % (kBK / 4));
  const float* ap[kAPer];
  bool avalid[kAPer];
#pragma unroll
  for (int j = 0; j < kAPer; ++j) {
    const int row = m0 + arow + j * kARows;
    avalid[j] = row < T;
    ap[j] = u + (((size_t)pos * a.g + grp) * T + (avalid[j] ? row : 0)) * cu
            + acol;
  }
  // the B copies: rows brow + j kRows of the chunk, column bcol of the
  // tile, from slab + wcol + crow[channel] (wcol < 0: a column past K)
  constexpr int kRow = VB ? BN / 4 : BN;          // copies a B row takes
  constexpr int kRows = kThreads / kRow;          // rows a pass of copies
  constexpr int kBPer = (kBK + kRows - 1) / kRows;
  static_assert(kThreads % kRow == 0 && (kBK % kRows == 0 || kRows > kBK),
                "B copies fill whole passes or part of one");
  const int brow = t / kRow, bcol = (VB ? 4 : 1) * (t % kRow);
  const int n = n0 + bcol;
  const int wcol = n < a.K ? ((grp * a.nkb + n / a.Kb) * a.ncb) * tile_elems
                                 + pos * a.Cs * a.Kb + n % a.Kb
                           : -1;
  __syncthreads();

  auto load_chunk = [&](int stage, int k0) {
    if (acopies) {
#pragma unroll
      for (int j = 0; j < kAPer; ++j)
        cp_async16(As + stage * BM * kApad + (arow + j * kARows) * kApad
                       + acol,
                   ap[j] + k0, avalid[j]);
    }
    float* bs = Bs + stage * kBK * BN + bcol;
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int kk = brow + j * kRows;
      if (kRows > kBK && kk >= kBK) continue;     // a partial pass
      const int off = crow[k0 + kk];
      const bool ok = off >= 0 && wcol >= 0;
      const float* src = ok ? slab + wcol + off : slab;
      if (VB) cp_async16(bs + kk * BN, src, ok);
      else cp_async4(bs + kk * BN, src, ok);
    }
  };

  const int nchunks = cu / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, s * kBK);
    cp_async_commit();
  }
  if constexpr (ARMED)          // its partial sums after the channel table
    abft_check_slab<unsigned>(a, npos, slab, (unsigned*)(crow + cu));

  // thread (tm, tn) of the 16 x 16 owns rows tm + 16 i and columns
  // tn * TN + j of the tile; a warp spans 4 tm x 8 tn, so its float4
  // reads of A (4 rows, 80 bytes apart) and of B (8 neighbours) each take
  // one shared-memory wavefront
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

  const int nt0 = n0 + tn * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + tm + 16 * i;
    if (row >= T) continue;
    float* mp = m + (((size_t)pos * a.g + grp) * T + row) * a.K + nt0;
    if constexpr (TN % 4 == 0) {
      if (a.K % 4 == 0) {               // whole float4s, in range or not
#pragma unroll
        for (int j = 0; j < TN; j += 4)
          if (nt0 + j < a.K)
            *reinterpret_cast<float4*>(mp + j) = make_float4(
                acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (nt0 + j < a.K) mp[j] = acc[i][j];
  }
}

// Grid ceil(T * g * K / kPointThreads): one thread a (tile, group, output
// channel), channels fastest.  y = A^T m A: the (n, n) Winograd-domain sums
// -> (m, m) outputs, A^T m made a column of m at a time.  y: (B, out_h,
// out_w, g*K), f32, or with narrow set (bf16, no epilogue launch after)
// the bf16 output; XT: the bias's element type; N: the tile size n.
template <typename XT, int N>
__global__ void __launch_bounds__(kPointThreads)
conv_winograd_inverse(ConvArgs a, WinoMats<N> mt,
                      const float* __restrict__ m,
                      const XT* __restrict__ bias, void* __restrict__ y,
                      int narrow) {
  constexpr int M = N - 2;
  const int T = a.B * tiles_per_image(a, M);
  const long long idx = (long long)blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= (long long)T * a.g * a.K) return;
  const int k = (int)(idx % a.K);
  const int grp = (int)(idx / a.K % a.g);
  const int t = (int)(idx / ((long long)a.K * a.g));
  const size_t pos_stride = (size_t)a.g * T * a.K;
  const float* mp = m + ((size_t)grp * T + t) * a.K + k;
  float tmp[M][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float col[N];
#pragma unroll
    for (int i = 0; i < N; ++i) col[i] = mp[(i * N + j) * pos_stride];
#pragma unroll
    for (int p = 0; p < M; ++p) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) s = fmaf(mt.at[p * N + i], col[i], s);
      tmp[p][j] = s;
    }
  }
  const int b = t / tiles_per_image(a, M), r = t % tiles_per_image(a, M);
  const int oy = (r / tiles_w(a, M)) * M, ox = (r % tiles_w(a, M)) * M;
  const int kf = a.g * a.K, kk = grp * a.K + k;
  const float bk = widen(bias[kk]);
#pragma unroll
  for (int p = 0; p < M; ++p)
#pragma unroll
    for (int q = 0; q < M; ++q) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) s = fmaf(tmp[p][j], mt.at[q * N + j], s);
      if (oy + p < a.out_h && ox + q < a.out_w)
        store_out(y,
                  (((size_t)b * a.out_h + oy + p) * a.out_w + ox + q) * kf
                      + kk,
                  bias_relu(s, bk, a.relu), narrow);
    }
}

// Grid (pooled tiles of PT x PT, B): LRN + max-pool from the conv map y.
__global__ void __launch_bounds__(kThreads)
conv_winograd_epilogue(ConvArgs a, const float* __restrict__ y,
                       void* __restrict__ out) {
  fused_epilogue(a, y, out);
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// The batched GEMM's launch geometry: T tiles, npos = n^2 positions.
struct GemmShape {
  int T, npos;
};

template <int TM, int TN, bool VB, bool ARMED>
cudaError_t launch_gemm(const ConvArgs& a, GemmShape gs, size_t smem,
                        cudaStream_t stream, const float* u,
                        const float* slab, float* m) {
  auto kernel = conv_winograd_gemm<TM, TN, VB, ARMED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_for(gs.T, 16 * TM), blocks_for(a.K, 16 * TN),
                  gs.npos * a.g);
  kernel<<<grid, kThreads, smem, stream>>>(a, gs.T, gs.npos, u, slab, m);
  return cudaGetLastError();
}

// ANY_SLAB: built for 4-byte slab copies too (the default tile); the
// other tiles take 16-byte ones only and refuse a slab without them.
template <int TM, int TN, bool ANY_SLAB>
cudaError_t launch_tile(const ConvArgs& a, GemmShape gs, size_t smem,
                        bool vb, cudaStream_t stream, const float* u,
                        const float* slab, float* m) {
  if (vb)
    return a.verdict ? launch_gemm<TM, TN, true, true>(a, gs, smem, stream,
                                                       u, slab, m)
                     : launch_gemm<TM, TN, true, false>(a, gs, smem, stream,
                                                        u, slab, m);
  if constexpr (ANY_SLAB)
    return a.verdict ? launch_gemm<TM, TN, false, true>(a, gs, smem, stream,
                                                        u, slab, m)
                     : launch_gemm<TM, TN, false, false>(a, gs, smem, stream,
                                                         u, slab, m);
  return cudaErrorInvalidValue;
}

// Whether the GEMM stage is built for this tile (rows and columns per
// thread) and slab: the default tile for any slab, the others for 16-byte
// slab copies (kernels/conv/winograd.py's TILES and ANY_SLAB_TILES).
bool built_for(int tm, int tn, bool vb) {
  return (tm == 4 && tn == 4)
         || (vb && ((tm == 2 && tn == 4) || (tm == 4 && tn == 2)
                    || (tm == 8 && tn == 4)));
}

cudaError_t launch_gemm_stage(int tm, int tn, const ConvArgs& a,
                              GemmShape gs, size_t smem, bool vb,
                              cudaStream_t stream, const float* u,
                              const float* slab, float* m) {
  if (tm == 4 && tn == 4)
    return launch_tile<4, 4, true>(a, gs, smem, vb, stream, u, slab, m);
  if (tm == 2 && tn == 4)
    return launch_tile<2, 4, false>(a, gs, smem, vb, stream, u, slab, m);
  if (tm == 4 && tn == 2)
    return launch_tile<4, 2, false>(a, gs, smem, vb, stream, u, slab, m);
  if (tm == 8 && tn == 4)
    return launch_tile<8, 4, false>(a, gs, smem, vb, stream, u, slab, m);
  return cudaErrorInvalidValue;
}

// The transform stages of tile size N, x and the bias of type XT: the
// input transform, or (inverse) the inverse transform into dst.  mats:
// host B^T (n x n) then A^T (m x n), row-major, m = n - 2.
template <typename XT, int N>
cudaError_t launch_transform(bool inverse, const ConvArgs& a,
                             const float* mats, long long T,
                             cudaStream_t stream, const void* x, float* u,
                             const float* m, const void* bias, void* dst,
                             int narrow) {
  WinoMats<N> mt;
  for (int i = 0; i < N * N; ++i) mt.bt[i] = mats[i];
  for (int i = 0; i < (N - 2) * N; ++i) mt.at[i] = mats[N * N + i];
  if (inverse)
    conv_winograd_inverse<XT, N>
        <<<blocks_for(T * a.g * a.K, kPointThreads), kPointThreads, 0,
           stream>>>(a, mt, m, static_cast<const XT*>(bias), dst, narrow);
  else
    conv_winograd_input<XT, N>
        <<<blocks_for(T * a.g * u_channels(a), kPointThreads),
           kPointThreads, 0, stream>>>(a, mt, static_cast<const XT*>(x), u);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_transform_n(int n, bool inverse, const ConvArgs& a,
                               const float* mats, long long T,
                               cudaStream_t stream, const void* x, float* u,
                               const float* m, const void* bias, void* dst,
                               int narrow) {
#define REPRO_WINO_N(NN)                                                   \
  case NN:                                                                 \
    return launch_transform<XT, NN>(inverse, a, mats, T, stream, x, u, m,  \
                                    bias, dst, narrow);
  switch (n) {
    REPRO_WINO_N(4)
    REPRO_WINO_N(5)
    REPRO_WINO_N(6)
    REPRO_WINO_N(7)
    REPRO_WINO_N(8)
    REPRO_WINO_N(9)
    REPRO_WINO_N(10)
    REPRO_WINO_N(11)
    REPRO_WINO_N(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_WINO_N
}

}  // namespace

// mats: host array of B^T (n x n) then A^T (m x n), row-major, n = m + 2;
// m: outputs a tile side, 2..10.  x, bias and out in args->xdt's element
// type (f32 or bf16), the slab f32 (args->sdt).  u: (n^2, g, T, Cu) and m:
// (n^2, g, T, K) f32 scratch, T = B * ceil(out_h / m) * ceil(out_w / m);
// y: (B, out_h, out_w, g*K) f32 scratch for the epilogue launch (unused,
// and may equal out, with no LRN and no pool); tm, tn: rows and columns
// per thread of the GEMM's 16 tm x 16 tn block tile (the default is 4 x
// 4).  Armed (args->verdict set, args->Cs = Cb + 1), the GEMM stage also
// adds the slab's mismatched checksum lanes to *args->verdict.
extern "C" int repro_conv_winograd(const ConvArgs* args, const float* mats,
                                   int wm, const void* x, const float* slab,
                                   const void* bias, float* u, float* m,
                                   float* y, void* out, int tm, int tn,
                                   cudaStream_t stream) {
  const ConvArgs a = *args;
  const int n = wm + 2;
  const size_t slab_elems =
      (size_t)a.g * a.nkb * a.ncb * n * n * a.Cs * a.Kb;
  const size_t smem =
      gemm_smem_bytes(tm, tn, u_channels(a), a.verdict != nullptr);
  const bool vb = a.Kb % 4 == 0 && (uintptr_t)slab % 16 == 0;
  const bool bf16 = a.xdt == kBf16;
  if ((a.xdt != kF32 && !bf16) || a.sdt != kF32 || n < kMinN || n > kMaxN
      || !built_for(tm, tn, vb) || a.r != 3 || a.s != 1 || a.PT < 1
      || slab_elems >= (1u << 31) || smem > 227 * 1024 || (uintptr_t)u % 16
      || (uintptr_t)m % 16 || a.Cs != a.Cb + (a.verdict ? 1 : 0)
      || mats == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long T = (long long)a.B * tiles_per_image(a, wm);
  if (T * n * n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      bf16 ? launch_transform_n<__nv_bfloat16>(n, false, a, mats, T, stream, x,
                                               u, m, bias, nullptr, 0)
           : launch_transform_n<float>(n, false, a, mats, T, stream, x, u, m,
                                       bias, nullptr, 0);
  if (err != cudaSuccess) return (int)err;

  err = launch_gemm_stage(tm, tn, a, GemmShape{(int)T, n * n}, smem, vb,
                          stream, u, slab, m);
  if (err != cudaSuccess) return (int)err;

  const bool epilogue = a.lrn_n || a.pwin != 1 || a.ps != 1;
  void* dst = epilogue ? (void*)y : out;
  err = bf16 ? launch_transform_n<__nv_bfloat16>(n, true, a, mats, T, stream,
                                                 x, u, m, bias, dst,
                                                 !epilogue)
             : launch_transform_n<float>(n, true, a, mats, T, stream, x, u, m,
                                         bias, dst, 0);
  if (err != cudaSuccess || !epilogue) return (int)err;

  const int nph = (a.ph_out + a.PT - 1) / a.PT;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  conv_winograd_epilogue<<<dim3(nph * npw, a.B), kThreads, 0, stream>>>(
      a, y, out);
  return (int)cudaGetLastError();
}
