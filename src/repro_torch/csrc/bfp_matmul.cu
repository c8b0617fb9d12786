// Shared-exponent block-floating-point matmul: out (M, N) f32 = x (M, K)
// f32 or bf16 @ W (K, N), with W streamed as int8 mantissas plus one int8
// exponent per (K-block, column) and x quantized here, per (row, K-block),
// the same way.
//
// Replaces the TPU kernel _bfp_kernel (src/repro/kernels/bfp_matmul/
// bfp_matmul.py:29): AlexNet's fc6 (9216 -> 4096), fc7 (4096 -> 4096) and
// fc8 (4096 -> 1000) under fc_bfp at M = 1..8 rows (the bucket ladder), and
// the LM fc_bfp head.
//
// What bounds it on an H100: bytes.  Each weight is one byte read once and
// takes 2*M operations, so at M <= 8 the int8 weight stream (fc6: 37.7 MB,
// 11 us at 3.35 TB/s) is the roof, far above the tensor cores' int8 rate.
// Two launches from one entry:
//   1. a pre-pass quantizes x once a call into int8 mantissas, packed 4 k a
//      word as (ceil(M / 8), K / 4, 8) int32 (8 rows of one k-word side by
//      side), and exponents (ceil(M / 8), K / BLOCK, 8) int32, zeros for
//      the rows past M; kernels/bfp_matmul/bfp_matmul.py
//      quantize_activations is its plain twin.  A bf16 x (a bf16 model's
//      activations, as the reference's bfp_linear casts them to f32) is
//      read as bf16 and widened in registers: widening is exact, so the
//      mantissas and exponents, and the output, are bit for bit those of
//      the f32 kernel on x.float(), with no cast launch;
//   2. a GEMM, launched programmatically dependent on the pre-pass so it
//      loads its first weights before it waits for x.  A block owns 8 rows
//      by C = 8 or 16 columns (bfp_matmul.tile_cols: the wider if its grid
//      still covers the SMs) over all of K, with 8 warps: in each
//      round warp w takes K-block 8 r + w.  A lane loads its weight words
//      straight into registers, V = C / 8 consecutive columns of a k-word
//      row in one 4V-byte load (the (K/4, N, 4) stream: C columns of one
//      k-word are 4C contiguous bytes), and keeps 8-12 rounds of loads in
//      flight.  Each K-block's exact integer dot is V s8 tensor-core
//      mma.sync (m16n8k32 for BLOCK 32, m16n8k16 for BLOCK 16; A rows 8-15
//      are zero), mma i taking columns V j + i, so a lane ends up with 2V
//      consecutive columns of one row.  The warps write their products to
//      shared memory and one thread per output adds a round's 8 products
//      to its sum in K-block order.
//
// Function (bit-equal to bfp_matmul_plain in kernels/bfp_matmul/
// bfp_matmul.py).  Per (row, K-block) of x: amax = max|x|, e = frexp
// exponent of amax (0 for a block of zeros), q = clip(rint(x * 2^(7-e)),
// -127, 127), rint being half-to-even.  Per K-block the integer dot of the
// mantissas is exact (|dot| <= BLOCK * 127^2 < 2^24, so its float is exact
// too); it is scaled by 2^(e_x + e_w - 14), built from the exponent bits,
// and added into one f32 sum per output in ascending K-block order with
// separate IEEE multiply and add (__fmul_rn, __fadd_rn: never contracted
// to an FMA, no atomics, no split-K).  A K-block of a row that holds a NaN
// or an infinity makes that row's outputs NaN, so a poisoned input stays
// visible downstream.  Build without --use_fast_math: it would flush the
// subnormal scales of near-zero blocks to zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                   // x rows a block (A rows 0-7)
constexpr int kGemmWarps = 8;              // K-blocks a round, one a warp
constexpr int kGemmThreads = 32 * kGemmWarps;
constexpr int kBad = 1 << 20;              // exponent of a non-finite block
constexpr int kPrepThreads = 256;

// 2^n exactly, as ldexpf(1.0f, n): from the exponent bits (subnormal below
// 2^-126, 0 below 2^-149, inf above 2^127), with selects and no branch;
// core/bfp.py pow2 is its twin
__device__ __forceinline__ float pow2f(int n) {
  n = min(max(n, -150), 128);
  const unsigned normal = static_cast<unsigned>(n + 127) << 23;  // 128: inf
  const unsigned sub = n >= -149 ? 1u << ((n + 149) & 31) : 0u;
  return __uint_as_float(n >= -126 ? normal : sub);
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

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// four consecutive values of x from a 16-byte (f32) or 8-byte (bf16)
// aligned address, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// 1. one thread per (row of the padded 8-row tiles, K-block); XT: x's
// element type
template <int BLOCK, typename XT>
__global__ void __launch_bounds__(kPrepThreads)
    bfp_quantize_kernel(const XT* __restrict__ x, int* __restrict__ xq,
                        int* __restrict__ xe, int M, int K) {
  pdl_trigger();   // the GEMM may start streaming weights; it waits for x
  constexpr int kWords = BLOCK / 4;
  const int KB = K / BLOCK, KW = K / 4;
  const int t = blockIdx.x * kPrepThreads + threadIdx.x;
  const int r = t & (kRows - 1), kb = (t / kRows) % KB,
            mt = t / (kRows * KB);
  if (mt >= (M + kRows - 1) / kRows) return;
  const int m = mt * kRows + r;
  float4 v[kWords];
  const XT* xp = x + (size_t)m * K + (size_t)kb * BLOCK;
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    v[j] = m < M ? load4(xp + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
  float amax = 0.0f;
  int finite = 1;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                             fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
    finite &= finite4(v[j]);
  }
  int e = 0;
  if (amax > 0.0f && finite) frexpf(amax, &e);
  const float scale = pow2f(7 - e);
  int* out = xq + ((size_t)mt * KW + (size_t)kb * kWords) * kRows + r;
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    out[j * kRows] = static_cast<int>(
        quant8(v[j].x, scale) | (quant8(v[j].y, scale) << 8) |
        (quant8(v[j].z, scale) << 16) | (quant8(v[j].w, scale) << 24));
  xe[((size_t)mt * KB + kb) * kRows + r] = finite ? e : kBad;
}

// exact s8 dots of rows 0-7 (A rows 8-15 are zero) with 8 columns: lane
// (g = lane / 4, c = lane % 4) gets rows g, columns 2c and 2c + 1
__device__ __forceinline__ void mma_k32(int a0, int a2, int b0, int b1,
                                        int& d0, int& d1) {
  int d2, d3;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
      : "r"(a0), "r"(0), "r"(a2), "r"(0), "r"(b0), "r"(b1), "r"(0));
}

__device__ __forceinline__ void mma_k16(int a0, int b0, int& d0, int& d1) {
  int d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
      : "r"(a0), "r"(0), "r"(b0), "r"(0));
}

template <int C>
struct Tile {
  static_assert(C == 8 || C == 16, "column tiles of 8 or 16");
  static constexpr int kV = C / 8;         // words a lane loads a W row
  static constexpr int kU = C == 8 ? 12 : 8;   // rounds of loads ahead
  static constexpr int kPart = C + 4;      // floats a row of products
};

// one warp's operands of one K-block, in registers: lane (g, c) holds the W
// words of k-word rows c (and c + 4) at columns n0 + V g .. + V - 1, the x
// words of row g at the same k-words, row g's exponent and the exponents of
// the lane's output columns n0 + 2 V c .. + 2 V - 1
template <int BLOCK, int C>
struct Stage {
  static constexpr int kR = BLOCK / 16;    // k-word rows a lane loads
  static constexpr int kV = Tile<C>::kV;
  unsigned w[kR][kV];
  int x[kR];
  int ex;
  unsigned ew;   // 2V exponent bytes
};

template <int BLOCK, int C>
__device__ __forceinline__ void load_w(Stage<BLOCK, C>& st,
                                       const int* __restrict__ wq,
                                       const int8_t* __restrict__ we, int kb,
                                       int KB, int N, int n0, int g, int c) {
  constexpr int kV = Tile<C>::kV;
  const bool kv = kb < KB;
#pragma unroll
  for (int r = 0; r < Stage<BLOCK, C>::kR; ++r) {
    const int n = n0 + kV * g;
    const int* src = wq + (size_t)(kb * (BLOCK / 4) + c + 4 * r) * N + n;
    if (kv && n + kV <= N && (N % kV) == 0) {
      if constexpr (kV == 2) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
        st.w[r][0] = u.x, st.w[r][1] = u.y;
      } else {
        st.w[r][0] = __ldg(reinterpret_cast<const unsigned*>(src));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        st.w[r][i] = kv && n + i < N
                         ? __ldg(reinterpret_cast<const unsigned*>(src + i))
                         : 0u;
    }
  }
  const int n = n0 + 2 * kV * c;
  const int8_t* src = we + (size_t)kb * N + n;
  if (kv && n + 2 * kV <= N && (N % (2 * kV)) == 0) {
    if constexpr (kV == 2)
      st.ew = __ldg(reinterpret_cast<const unsigned*>(src));
    else
      st.ew = __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    st.ew = 0u;
#pragma unroll
    for (int i = 0; i < 2 * kV; ++i)
      if (kv && n + i < N)
        st.ew |= (static_cast<unsigned>(src[i]) & 0xffu) << (8 * i);
  }
}

template <int BLOCK, int C>
__device__ __forceinline__ void load_x(Stage<BLOCK, C>& st,
                                       const int* __restrict__ xq,
                                       const int* __restrict__ xe, int kb,
                                       int KB, int KW, int mt, int g, int c) {
  const bool kv = kb < KB;
#pragma unroll
  for (int r = 0; r < Stage<BLOCK, C>::kR; ++r)
    st.x[r] = kv ? __ldg(xq + ((size_t)mt * KW + kb * (BLOCK / 4) + c + 4 * r)
                                  * kRows + g)
                 : 0;
  st.ex = kv ? __ldg(xe + ((size_t)mt * KB + kb) * kRows + g) : 0;
}

// the exponent byte i of the lane's columns
template <int BLOCK, int C>
__device__ __forceinline__ int ew_of(const Stage<BLOCK, C>& st, int i) {
  return static_cast<int>(static_cast<int8_t>(st.ew >> (8 * i)));
}

// 2. grid (ceil(N / C), ceil(M / 8)), 8 warps: in round r warp w takes
// K-block 8 r + w, writes its 8 x C products to shared memory, and thread
// (m, n) adds the round's 8 products to its sum in K-block order
template <int BLOCK, int C>
__global__ void __launch_bounds__(kGemmThreads)
    bfp_gemm_kernel(const int* __restrict__ xq, const int* __restrict__ xe,
                    const int* __restrict__ wq, const int8_t* __restrict__ we,
                    float* __restrict__ out, int M, int K, int N) {
  using TL = Tile<C>;
  constexpr int kV = TL::kV, kU = TL::kU;
  __shared__ __align__(16) float part[2][kGemmWarps][kRows][TL::kPart];
  const int KW = K / 4, KB = K / BLOCK;
  const int rounds = (KB + kGemmWarps - 1) / kGemmWarps;
  const int n0 = blockIdx.x * C, mt = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;

  // the weights do not depend on the pre-pass: load them first
  Stage<BLOCK, C> st[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u)
    load_w(st[u], wq, we, u * kGemmWarps + warp, KB, N, n0, g, c);
  pdl_wait();
#pragma unroll
  for (int u = 0; u < kU; ++u)
    load_x(st[u], xq, xe, u * kGemmWarps + warp, KB, KW, mt, g, c);

  const float nan = __int_as_float(0x7fc00000);
  float acc = 0.0f;
  for (int r0 = 0; r0 < rounds; r0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u;
      if (r >= rounds) break;
      // exact dots: mma i holds columns n0 + V j + i (j = the B column)
      int d[kV][2];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        if constexpr (BLOCK == 32)
          mma_k32(st[u].x[0], st[u].x[1], st[u].w[0][i], st[u].w[1][i],
                  d[i][0], d[i][1]);
        else
          mma_k16(st[u].x[0], st[u].w[0][i], d[i][0], d[i][1]);
      }
      // lane (g, c): row g, columns 2 V c + i (d[i][0]) and + V + i (d[i][1])
      float p[2 * kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = h * kV + i;
          p[j] = st[u].ex == kBad
                     ? nan
                     : __fmul_rn(static_cast<float>(d[i][h]),
                                 pow2f(st[u].ex + ew_of(st[u], j) - 14));
        }
      }
      float* row = &part[r & 1][warp][g][2 * kV * c];
#pragma unroll
      for (int j = 0; j < 2 * kV; j += 2)
        *reinterpret_cast<float2*>(row + j) = make_float2(p[j], p[j + 1]);
      // the next loads into this stage
      const int kb = (r + kU) * kGemmWarps + warp;
      load_w(st[u], wq, we, kb, KB, N, n0, g, c);
      load_x(st[u], xq, xe, kb, KB, KW, mt, g, c);
      __syncthreads();
      if (tid < kRows * C) {
        const float* q = &part[r & 1][0][tid / C][tid % C];
#pragma unroll
        for (int w = 0; w < kGemmWarps; ++w)
          acc = __fadd_rn(acc, q[w * kRows * TL::kPart]);
      }
    }
  }
  const int m = mt * kRows + tid / C, n = n0 + tid % C;
  if (tid < kRows * C && m < M && n < N) out[(size_t)m * N + n] = acc;
}

template <int BLOCK, int C>
int launch_gemm(const int* xq, const int* xe, const int* wq, const int8_t* we,
                float* out, int M, int K, int N, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C - 1) / C, (M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, bfp_gemm_kernel<BLOCK, C>, xq, xe, wq,
                                 we, out, M, K, N);
}

template <int BLOCK, typename XT>
int launch(const XT* x, const int* wq, const int8_t* we, int* scratch,
           float* out, int M, int K, int N, int cols, cudaStream_t stream) {
  const int Mt = (M + kRows - 1) / kRows;
  int* xq = scratch;                                   // (Mt, K/4, 8)
  int* xe = scratch + (size_t)Mt * (K / 4) * kRows;    // (Mt, K/BLOCK, 8)
  const long long threads = (long long)Mt * kRows * (K / BLOCK);
  bfp_quantize_kernel<BLOCK, XT>
      <<<(unsigned)((threads + kPrepThreads - 1) / kPrepThreads),
         kPrepThreads, 0, stream>>>(x, xq, xe, M, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (cols) {
    case 8:
      return launch_gemm<BLOCK, 8>(xq, xe, wq, we, out, M, K, N, stream);
    case 16:
      return launch_gemm<BLOCK, 16>(xq, xe, wq, we, out, M, K, N, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename XT>
int launch_block(const XT* x, const int* w, const int8_t* we, int* scratch,
                 float* out, int M, int K, int N, int block, int cols,
                 cudaStream_t stream) {
  switch (block) {
    case 16:
      return launch<16>(x, w, we, scratch, out, M, K, N, cols, stream);
    case 32:
      return launch<32>(x, w, we, scratch, out, M, K, N, cols, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in xdt's element type (0 = float32, 1 = bfloat16), 16-byte
// aligned; scratch: int32, ceil(M / 8) * 8 * (K / 4 + K / block) words (the
// pre-pass's x words, then its exponents); cols: output columns a block
extern "C" int repro_bfp_matmul(const void* x, const int8_t* wq,
                                const int8_t* we, int* scratch, float* out,
                                int M, int K, int N, int block, int cols,
                                int xdt, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0 || K % block ||
      (M + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const int* w = reinterpret_cast<const int*>(wq);
  switch (xdt) {
    case 0:
      return launch_block(static_cast<const float*>(x), w, we, scratch, out,
                          M, K, N, block, cols, stream);
    case 1:
      return launch_block(static_cast<const __nv_bfloat16*>(x), w, we,
                          scratch, out, M, K, N, block, cols, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
