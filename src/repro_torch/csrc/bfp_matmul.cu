// Shared-exponent block-floating-point matmul: out (M, N) f32 = x (M, K) f32
// @ W (K, N), with W streamed as int8 mantissas plus one int8 exponent per
// (K-block, column) and x quantized here, per (row, K-block), the same way.
//
// Replaces the TPU kernel _bfp_kernel (src/repro/kernels/bfp_matmul/
// bfp_matmul.py:29): AlexNet's fc6 (9216 -> 4096), fc7 (4096 -> 4096) and
// fc8 (4096 -> 1000) under fc_bfp, at M = 1..8 rows (the bucket ladder).
//
// What bounds it on an H100: bytes.  Each weight is one byte read once and
// takes 2*M operations, so at M <= 8 the int8 weight stream (fc6: 37.7 MB,
// 11 us at 3.35 TB/s) is the roof, far above the tensor cores' int8 rate.
// The design reads that stream coalesced and keeps many loads in flight:
// the stream's layout packs 4 consecutive k of one column into one 32-bit
// word ((K/4, N, 4) int8), so the 32 lanes of a warp, one column each, read
// 128 contiguous bytes per load; each warp owns 2 K-blocks of every
// 16-K-block round, and the next round's words are loaded into registers
// while the current round computes.  Tensor cores, TMA and a deeper
// pipeline are later work.
//
// Function (bit-equal to bfp_matmul_plain in kernels/bfp_matmul/
// bfp_matmul.py).  Per (row, K-block) of x: amax = max|x|, e = frexp
// exponent of amax (0 for a block of zeros), q = clip(rint(x * 2^(7-e)),
// -127, 127), rint being half-to-even.  Per K-block the integer dot of the
// mantissas is exact (__dp4a, |dot| <= BLOCK * 127^2 < 2^24, so its float
// is exact too); it is scaled by 2^(e_x + e_w - 14), built from the
// exponent bits, and added into one f32 sum per output in ascending K-block
// order with separate IEEE multiply and add (__fmul_rn, __fadd_rn: never
// contracted to an FMA, no atomics, no split-K).  A K-block of a row that
// holds a NaN or an infinity makes that row's outputs NaN, so a poisoned
// input stays visible downstream.  Build without --use_fast_math: it would
// flush the subnormal scales of near-zero blocks to zero.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                  // output columns per block (lanes)
constexpr int kRows = 8;                   // output rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKbw = 2;                    // K-blocks per warp per round
constexpr int kRoundKb = kWarps * kKbw;    // K-blocks per round
constexpr int kBad = 1 << 20;              // exponent of a non-finite block

// 2^n exactly, as ldexpf(1.0f, n): from the exponent bits (subnormal below
// 2^-126, 0 below 2^-149, inf above 2^127); core/bfp.py pow2 is its twin
__device__ __forceinline__ float pow2f(int n) {
  if (n > 127) return __int_as_float(0x7f800000);
  if (n >= -126) return __int_as_float((n + 127) << 23);
  if (n >= -149) return __int_as_float(1 << (n + 149));
  return 0.0f;
}

__device__ __forceinline__ int finite4(float4 v) {
  const unsigned inf = 0x7f800000u;
  return ((__float_as_uint(v.x) & inf) != inf) &
         ((__float_as_uint(v.y) & inf) != inf) &
         ((__float_as_uint(v.z) & inf) != inf) &
         ((__float_as_uint(v.w) & inf) != inf);
}

// the mantissa byte of v: clip(rint(v * scale), -127, 127), half-to-even
__device__ __forceinline__ unsigned quant8(float v, float scale) {
  const float q = fmaxf(fminf(rintf(__fmul_rn(v, scale)), 127.0f), -127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// one round's operands of one lane, in registers
template <int BLOCK>
struct Stage {
  float4 x[kKbw][BLOCK / 16];   // a quarter of one row's K-block
  int w[kKbw][BLOCK / 4];       // the lane's column: mantissa words
  int e[kKbw];                  // the lane's column: exponent
};

template <int BLOCK>
__device__ __forceinline__ void load_stage(
    Stage<BLOCK>& s, int round, const float* __restrict__ x,
    const int* __restrict__ wq, const int8_t* __restrict__ we, int M, int K,
    int N, int KB, int m0, int n, int warp, int lane) {
  const int row = m0 + (lane >> 2), quarter = lane & 3;
#pragma unroll
  for (int i = 0; i < kKbw; ++i) {
    const int kb = round * kRoundKb + warp * kKbw + i;
    const bool kv = kb < KB;
    const bool xv = kv && row < M, wv = kv && n < N;
    const float4* xp = reinterpret_cast<const float4*>(
        x + (size_t)row * K + (size_t)kb * BLOCK + quarter * (BLOCK / 4));
#pragma unroll
    for (int j = 0; j < BLOCK / 16; ++j)
      s.x[i][j] = xv ? xp[j] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < BLOCK / 4; ++j)
      s.w[i][j] = wv ? wq[((size_t)kb * (BLOCK / 4) + j) * N + n] : 0;
    s.e[i] = wv ? static_cast<int>(we[(size_t)kb * N + n]) : 0;
  }
}

// grid (ceil(N / 32), ceil(M / 8)); thread (warp, lane) sums output
// (m0 + warp, n0 + lane)
template <int BLOCK>
__global__ void __launch_bounds__(kThreads)
bfp_matmul_kernel(const float* __restrict__ x, const int* __restrict__ wq,
                  const int8_t* __restrict__ we, float* __restrict__ out,
                  int M, int K, int N) {
  constexpr int kWords = BLOCK / 4;        // mantissa words per K-block
  __shared__ __align__(16) int xs[kWarps][kKbw][kWords][kRows];
  __shared__ int xe[kWarps][kKbw][kRows];
  __shared__ float part[kRoundKb][kRows][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;
  const int n = n0 + lane;
  const int KB = K / BLOCK;
  const int rounds = (KB + kRoundKb - 1) / kRoundKb;
  const int row = lane >> 2, quarter = lane & 3;
  float acc = 0.0f;

  Stage<BLOCK> cur, nxt;
  load_stage(cur, 0, x, wq, we, M, K, N, KB, m0, n, warp, lane);
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds)
      load_stage(nxt, r + 1, x, wq, we, M, K, N, KB, m0, n, warp, lane);

    // A. quantize the warp's K-blocks of x: 4 lanes per row, reduced by
    // shuffles, packed 4 k per word (byte i = k offset i) into shared memory
#pragma unroll
    for (int i = 0; i < kKbw; ++i) {
      float amax = 0.0f;
      int finite = 1;
#pragma unroll
      for (int j = 0; j < BLOCK / 16; ++j) {
        const float4 v = cur.x[i][j];
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                 fmaxf(fabsf(v.z), fabsf(v.w))));
        finite &= finite4(v);
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      finite &= __shfl_xor_sync(0xffffffffu, finite, 1);
      finite &= __shfl_xor_sync(0xffffffffu, finite, 2);
      int e = 0;
      if (amax > 0.0f && finite) frexpf(amax, &e);
      const float scale = pow2f(7 - e);
#pragma unroll
      for (int j = 0; j < BLOCK / 16; ++j) {
        const float4 v = cur.x[i][j];
        xs[warp][i][quarter * (BLOCK / 16) + j][row] = static_cast<int>(
            quant8(v.x, scale) | (quant8(v.y, scale) << 8) |
            (quant8(v.z, scale) << 16) | (quant8(v.w, scale) << 24));
      }
      if (quarter == 0) xe[warp][i][row] = finite ? e : kBad;
    }
    __syncwarp();

    // B. exact integer dot per K-block, lane = column, all rows at once
#pragma unroll
    for (int i = 0; i < kKbw; ++i) {
      int dot[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) dot[m] = 0;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int4 lo = *reinterpret_cast<const int4*>(&xs[warp][i][j][0]);
        const int4 hi = *reinterpret_cast<const int4*>(&xs[warp][i][j][4]);
        const int w = cur.w[i][j];
        dot[0] = __dp4a(lo.x, w, dot[0]);
        dot[1] = __dp4a(lo.y, w, dot[1]);
        dot[2] = __dp4a(lo.z, w, dot[2]);
        dot[3] = __dp4a(lo.w, w, dot[3]);
        dot[4] = __dp4a(hi.x, w, dot[4]);
        dot[5] = __dp4a(hi.y, w, dot[5]);
        dot[6] = __dp4a(hi.z, w, dot[6]);
        dot[7] = __dp4a(hi.w, w, dot[7]);
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int ex = xe[warp][i][m];
        part[warp * kKbw + i][m][lane] =
            ex == kBad ? __int_as_float(0x7fc00000)
                       : __fmul_rn(static_cast<float>(dot[m]),
                                   pow2f(ex + cur.e[i] - 14));
      }
    }
    __syncthreads();

    // C. one f32 sum per output, over this round's K-blocks in order
    const int nkb = min(kRoundKb, KB - r * kRoundKb);
    for (int s = 0; s < nkb; ++s) acc = __fadd_rn(acc, part[s][warp][lane]);
    __syncthreads();
    cur = nxt;
  }
  if (m0 + warp < M && n < N) out[(size_t)(m0 + warp) * N + n] = acc;
}

}  // namespace

extern "C" int repro_bfp_matmul(const float* x, const int8_t* wq,
                                const int8_t* we, float* out, int M, int K,
                                int N, int block, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0 || K % block)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  const int* w = reinterpret_cast<const int*>(wq);
  switch (block) {
    case 16:
      bfp_matmul_kernel<16><<<grid, kThreads, 0, stream>>>(x, w, we, out, M,
                                                           K, N);
      break;
    case 32:
      bfp_matmul_kernel<32><<<grid, kThreads, 0, stream>>>(x, w, we, out, M,
                                                           K, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
