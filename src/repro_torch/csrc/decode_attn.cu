// Batched one-token GQA decode attention: for every slot b and query head h,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G]) . v[b, s, h / G]
// over the cache positions s < lengths[b], G = H / KV query heads sharing
// one KV head.  q is first scaled by D^-0.5 and rounded to its own dtype,
// as the reference does (the wrapper passes the factor, itself rounded to
// q's dtype); scores, the softmax and every sum are f32, and the output is
// written in q's dtype.  A slot of length 0 attends uniformly over all S
// positions (the reference masks every score to the same -1e30, so its
// softmax is uniform): its output is the mean of v.
//
// Replaces the TPU kernel _decode_kernel (src/repro/kernels/decode_attn/
// decode_attn.py:26), the serving engine's hot spot: one launch per layer
// per decode step, q (B, 1, H, D), caches (B, S, KV, D) in f32 or bf16,
// built for D in {8, 16, 32, 64, 96, 128}.  Nothing assumes a power of
// two: a lane's outputs are (head, d) = divmod(lane + 32 i, D), which
// needs 4 D % 32 == 0; a staged row is D * sizeof(T) + 16 bytes, a
// multiple of 16 for cp.async; the bf16 scores take D / 16 mma k-steps.
// The encoder-decoder's cross decode is the same kernel over the
// encoder's rows (per-slot lengths: the rows each prefill wrote); an MHA
// model (G = 1) leaves 3 of a block's 4 query-head rows idle.
//
// What bounds it on an H100: bytes.  Each valid K and V element is read
// once and takes 2 flops per query head of its group (G = 3 for smollm-360m
// and llama3.2-3b), far below the ~295 flops a byte at which the card
// stops being bound by memory.  So the design is about keeping the whole
// card streaming (flash decoding):
//   - split S: block (split, KV head x chunk of up to 4 query heads, slot)
//     owns cache rows [split * R, min((split + 1) * R, n)) of its slot, R
//     a pure function of the shape (kernels/decode_attn/decode_attn.py
//     split_rows), so a long slot spreads over many blocks and the grid
//     covers the SMs; a block whose range is empty returns at once;
//   - tiles: 32 rows of K and of V at a time go to shared memory with
//     16-byte cp.async in a 4-stage ring, and each of the 4 warps owns 8
//     rows of every tile with an online softmax of its own.  The scores:
//     in bf16 one tensor-core mma.sync (m16n8k16, f32 sums; the query
//     heads are the A rows, zero past G, the warp's K rows the B columns)
//     a 16-wide k-step; in f32 (and bf16 at D = 8) scalar dot products
//     in the same layout, lane (g, c) taking head g at rows 2c and 2c + 1
//     (no padded head).
//     Per tile and head one max and one sum over 4 lanes (2 shuffles
//     each), one expf a score, the accumulator rescaled once; p . V in f32
//     (f32 probabilities, f32 sums), each lane owning (head, d) outputs.
//     The block merges its 4 warps' states in warp order at the end;
//   - merge, in the same launch: a slot with one split writes its output
//     at once; else each block writes its partial state (acc[D], m, l) in
//     f32 to the wrapper's scratch (B, KV, splits, G, D + 2) and takes an
//     integer ticket (atomicAdd after __threadfence) from the wrapper's
//     zeroed ticket buffer, and the last of the ceil(n / R) used splits of
//     a (slot, KV head) to arrive merges them: each head's split weights
//     exp(m_s - max m) / sum_s l_s exp(m_s - max m) once into shared
//     memory, then every output as the sum of the splits' acc times their
//     weights, in ascending split order whatever the arrival order, and
//     it sets the ticket back to 0.  No float atomics: two calls give
//     equal bits.
// The lse mode (a non-null lse, f32 (B, H)): the same outputs, and each
// (slot, head)'s log-sum-exp of its scaled scores, m + log l of the merged
// state, so that the blocks of a cache split over ranks merge by their
// lse; a slot of length <= 0 then has no valid row: output 0, lse -inf
// (written by its split-0 blocks), where without lse it attends uniformly.
// Without lse every instruction of the kernel is the one it was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = kWarps;   // query heads a block (A rows of the mma)
constexpr int kTile = 32;        // cache rows a tile: 8 a warp
constexpr int kStages = 4;       // tiles in the cp.async ring
constexpr int kPad = 16;         // bytes after each staged row (banks)
constexpr float kNegInf = -1e30f;
constexpr int kMergeSplits = 4;  // splits a lane merges
constexpr int kMaxSplits = 32 * kMergeSplits;   // splits a slot

// a value of a row as f32 (bf16 is the top half of an f32), stores and
// roundings in the row's type
template <typename T>
struct Row;

template <>
struct Row<float> {
  __device__ static float at(const unsigned char* row, int d) {
    return reinterpret_cast<const float*>(row)[d];
  }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Row<__nv_bfloat16> {
  __device__ static float at(const unsigned char* row, int d) {
    return __uint_as_float(
        static_cast<unsigned>(reinterpret_cast<const uint16_t*>(row)[d])
        << 16);
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// dynamic shared memory of one block: the K and V rings (at the end the
// warps' states, then the split weights of a merge), q in f32, each warp's
// probabilities of its rows and each head's rescale factor
template <typename T, int D>
struct Smem {
  static constexpr int kRowBytes = D * (int)sizeof(T) + kPad;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kRing = kStages * kTileBytes;
  static constexpr int kQ = 2 * kRing;
  static constexpr int kP = kQ + kHeads * D * 4;
  static constexpr int kCorr = kP + kWarps * kHeads * 8 * 4;
  static constexpr int kBytes = kCorr + kWarps * kHeads * 4;
  static_assert(kWarps * kHeads * (D + 2) * 4 <= kRing &&
                    kHeads * kMaxSplits * 4 <= kRing,
                "merge areas");
};

// S[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 sums; A rows 8-15 are
// zero (a1 = a3 = 0), so d2 and d3 stay 0
__device__ __forceinline__ void mma_bf16(unsigned a0, unsigned a2,
                                         unsigned b0, unsigned b1, float& d0,
                                         float& d1, float& d2, float& d3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(0), "r"(a2), "r"(0), "r"(b0), "r"(b1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths,
                       float* __restrict__ part, int* __restrict__ tickets,
                       T* __restrict__ out, float* __restrict__ lse,
                       float scale, int S, int H, int KV, int R,
                       int splits) {
  using L = Smem<T, D>;
  constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int kOut = kHeads * D / 32;   // (head, d) outputs a lane
  // bf16 scores on the tensor cores (D a multiple of 16); else scalar
  // dot products
  constexpr bool kTensor =
      std::is_same<T, __nv_bfloat16>::value && D % 16 == 0;
  static_assert(kChunks >= 1 && kOut >= 1 && D % 8 == 0,
                "head dim a multiple of 8, 8..128");
  static_assert(kTile == 8 * kWarps, "a warp's 8 rows a tile");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* pw = reinterpret_cast<float*>(smem + L::kP);     // [warp][head][8]
  float* pc = reinterpret_cast<float*>(smem + L::kCorr);  // [warp][head]

  const int G = H / KV;
  const int chunks = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * kHeads;
  const int ng = min(kHeads, G - g0);
  const int b = blockIdx.z;
  const int len = lengths[b];
  const size_t head0 = (size_t)b * H + (size_t)kvh * G + g0;
  if (lse != nullptr && len <= 0) {   // an empty block: 0 and -inf
    if (blockIdx.x == 0) {
      for (int o = threadIdx.x; o < ng * D; o += kThreads)
        Row<T>::store(out + head0 * D + o, 0.0f);
      if (threadIdx.x < ng)
        lse[head0 + threadIdx.x] = __int_as_float(0xff800000);   // -inf
    }
    return;
  }
  const bool uniform = len <= 0;
  const int n = uniform ? S : min(len, S);
  const int r0 = blockIdx.x * R;
  if (r0 >= n) return;            // the slot uses ceil(n / R) splits
  const int r1 = min(r0 + R, n);
  const int ntiles = (r1 - r0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;   // head g, rows 2c and 2c + 1

  // stage tile t (rows r0 + 32 t ...) of K and V; rows past r1 are
  // zero-filled, so p = 0 meets v = 0 (never garbage past the length)
  const size_t row_stride = (size_t)KV * D * sizeof(T);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) +
                            ((size_t)b * S * KV + kvh) * D * sizeof(T);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) +
                            ((size_t)b * S * KV + kvh) * D * sizeof(T);
  auto load_tile = [&](int t) {
    const int slot = t % kStages;
    const int row0 = r0 + t * kTile;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, j = i % kChunks;
      const bool ok = row0 + r < r1;
      const size_t off = (ok ? (size_t)(row0 + r) * row_stride : 0) + j * 16;
      const int dst = slot * L::kTileBytes + r * L::kRowBytes + j * 16;
      cp_async16(reinterpret_cast<float*>(smem + dst),
                 reinterpret_cast<const float*>(kb + off), ok);
      cp_async16(reinterpret_cast<float*>(smem + L::kRing + dst),
                 reinterpret_cast<const float*>(vb + off), ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  for (int i = tid; i < ng * D; i += kThreads)   // q * D^-0.5 in T
    qs[i] = Row<T>::round(__fmul_rn(
        Row<T>::at(reinterpret_cast<const unsigned char*>(q + head0 * D), i),
        scale));
  __syncthreads();
  // the A fragments of q (rows = heads, zero past ng), one pair a k-step
  unsigned qa[kTensor ? D / 16 : 1][2];
  if constexpr (kTensor) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 16 * ks + 8 * h + 2 * c;
        const __nv_bfloat162 x = __floats2bfloat162_rn(
            g < ng ? qs[g * D + d] : 0.0f, g < ng ? qs[g * D + d + 1] : 0.0f);
        qa[ks][h] = *reinterpret_cast<const unsigned*>(&x);
      }
    }
  }

  // this warp's online softmax over its rows: lanes (g, *) hold head g's
  // running max and sum; lane output i is (head, d) = divmod(lane + 32 i, D)
  float m_run = kNegInf, l_run = 0.0f;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; everyone is done with tile t - 1
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* kt = smem + (t % kStages) * L::kTileBytes +
                              8 * warp * L::kRowBytes;   // the warp's rows
    const unsigned char* vt = kt + L::kRing;
    const int rows = min(kTile, r1 - (r0 + t * kTile)) - 8 * warp;

    // scores of head g at the warp's rows 2c and 2c + 1
    float s[2] = {0.0f, 0.0f};
    if (!uniform) {
      if constexpr (kTensor) {
        // the K rows are the B columns, 2 k a 32-bit word; even and odd
        // k-steps in two mma chains
        const unsigned char* kr = kt + g * L::kRowBytes + 4 * c;
        float d[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_bf16(qa[ks][0], qa[ks][1],
                   *reinterpret_cast<const unsigned*>(kr + 32 * ks),
                   *reinterpret_cast<const unsigned*>(kr + 32 * ks + 16),
                   d[ks & 1][0], d[ks & 1][1], d[ks & 1][2], d[ks & 1][3]);
        s[0] = d[0][0] + d[1][0];
        s[1] = d[0][1] + d[1][1];
      } else if (g < ng) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned char* kr = kt + (2 * c + e) * L::kRowBytes;
          float dot = 0.0f;
#pragma unroll 8
          for (int d = 0; d < D; ++d)
            dot = fmaf(qs[g * D + d], Row<T>::at(kr, d), dot);
          s[e] = dot;
        }
      }
    }
    const bool ok0 = g < ng && 2 * c < rows, ok1 = g < ng && 2 * c + 1 < rows;
    float tmax = fmaxf(ok0 ? s[0] : kNegInf, ok1 ? s[1] : kNegInf);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mn = fmaxf(m_run, tmax);
    const float p0 = ok0 ? expf(s[0] - mn) : 0.0f;
    const float p1 = ok1 ? expf(s[1] - mn) : 0.0f;
    float psum = p0 + p1;
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m_run - mn);
    l_run = l_run * corr + psum;
    m_run = mn;
    float* pww = pw + warp * kHeads * 8;
    if (g < kHeads) {
      *reinterpret_cast<float2*>(pww + g * 8 + 2 * c) = make_float2(p0, p1);
      if (c == 0) pc[warp * kHeads + g] = corr;
    }
    __syncwarp();

    // p . V over the warp's 8 rows, f32
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      acc[i] *= pc[warp * kHeads + (lane + 32 * i) / D];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int o = lane + 32 * i;
        acc[i] = fmaf(pww[(o / D) * 8 + r],
                      Row<T>::at(vt + r * L::kRowBytes, o % D), acc[i]);
      }
    }
  }

  // merge the warps' states in warp order, into the ring's memory
  __syncthreads();
  float* mw = reinterpret_cast<float*>(smem);     // [warp][head]
  float* lw = mw + kWarps * kHeads;               // [warp][head]
  float* aw = lw + kWarps * kHeads;               // [warp][head][D]
  if (c == 0 && g < kHeads) {
    mw[warp * kHeads + g] = m_run;
    lw[warp * kHeads + g] = l_run;
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i)
    aw[warp * kHeads * D + lane + 32 * i] = acc[i];
  __syncthreads();
  // the block's state for (head h, d) = divmod(o, D): its warps' states
  // merged in warp order
  auto state = [&](int o, float& mx, float& num, float& den) {
    const int h = o / D, d = o % D;
    mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kHeads + h]);
    num = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(mw[w * kHeads + h] - mx);
      num = fmaf(aw[(w * kHeads + h) * D + d], e, num);
      den = fmaf(lw[w * kHeads + h], e, den);
    }
  };
  T* outb = out + head0 * D;
  const int used = (n + R - 1) / R;
  if (used == 1) {   // the slot's only split: the output is this state
    for (int o = tid; o < ng * D; o += kThreads) {
      float mx, num, den;
      state(o, mx, num, den);
      Row<T>::store(outb + o, num / fmaxf(den, 1e-30f));
      if (lse != nullptr && o % D == 0) lse[head0 + o / D] = mx + logf(den);
    }
    return;
  }
  // else the partial state, acc[D] then m and l, per (slot, KV head, split,
  // g) into the scratch
  const size_t split_stride = (size_t)G * (D + 2);
  float* pb = part + ((size_t)b * KV + kvh) * splits * split_stride +
              (size_t)g0 * (D + 2);
  for (int o = tid; o < ng * D; o += kThreads) {
    const int h = o / D, d = o % D;
    float mx, num, den;
    state(o, mx, num, den);
    float* ph = pb + blockIdx.x * split_stride + (size_t)h * (D + 2);
    ph[d] = num;
    if (d == 0) {
      ph[D] = mx;
      ph[D + 1] = den;
    }
  }

  // the last of the slot's used splits to arrive takes an integer ticket
  // and merges them all, in split order (then resets the ticket)
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * gridDim.y + blockIdx.y;
  if (tid == 0) last = atomicAdd(ticket, 1) == used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // warp h: the weights exp(m_s - max m) / sum_s l_s exp(m_s - max m) of
  // head h's splits, each lane loading (m, l) of its splits from L2 once
  float* coef = reinterpret_cast<float*>(smem);   // [head][kMaxSplits]
  if (warp < ng) {
    const float* ph = pb + (size_t)warp * (D + 2) + D;
    float ms[kMergeSplits], ls[kMergeSplits];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) {
      const int sp = lane + 32 * j;
      ms[j] = sp < used ? __ldcg(ph + sp * split_stride) : kNegInf;
      ls[j] = sp < used ? __ldcg(ph + sp * split_stride + 1) : 0.0f;
      mx = fmaxf(mx, ms[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.0f;
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) {
      ms[j] = expf(ms[j] - mx);   // 0 past the used splits
      den = fmaf(ls[j], ms[j], den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    if (lse != nullptr && lane == 0) lse[head0 + warp] = mx + logf(den);
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j)
      if (lane + 32 * j < used)
        coef[warp * kMaxSplits + lane + 32 * j] = ms[j] * inv;
  }
  __syncthreads();
  for (int o = tid; o < ng * D; o += kThreads) {
    const int h = o / D, d = o % D;
    const float* ph = pb + (size_t)h * (D + 2) + d;
    float num = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < used; ++sp)
      num = fmaf(__ldcg(ph + sp * split_stride), coef[h * kMaxSplits + sp],
                 num);
    Row<T>::store(outb + o, num);
  }
  if (tid == 0) *ticket = 0;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part, int* tickets, void* out, float* lse, float scale,
           int B, int S, int H, int KV, int R, cudaStream_t stream) {
  const int G = H / KV;
  const int splits = (S + R - 1) / R;
  constexpr int smem = Smem<T, D>::kBytes;
  static bool sized = false;      // the > 48 KB opt-in, once an instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(splits, KV * ((G + kHeads - 1) / kHeads), B);
  decode_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part, tickets, static_cast<T*>(out),
      lse, scale, S, H, KV, R, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             float* part, int* tickets, void* out, float* lse, float scale,
             int B, int S, int H, int KV, int D, int R, cudaStream_t stream) {
  auto run = [&](auto launcher) {
    return launcher(q, k, v, lengths, part, tickets, out, lse, scale, B, S,
                    H, KV, R, stream);
  };
  switch (D) {
    case 8:
      return run(launch<T, 8>);
    case 16:
      return run(launch<T, 16>);
    case 32:
      return run(launch<T, 32>);
    case 64:
      return run(launch<T, 64>);
    case 96:
      return run(launch<T, 96>);
    case 128:
      return run(launch<T, 128>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out alike); part: f32
// scratch (B, KV, ceil(S / R), H / KV, D + 2); tickets: int32, B * KV *
// ceil(H / KV / 4), zero at the call and left zero; lse: f32 (B, H) or
// NULL (the mode without it); scale: D^-0.5 rounded to q's dtype; R:
// cache rows a split, a positive multiple of 32
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v,
                                 const int* lengths, float* part,
                                 int* tickets, void* out, float* lse,
                                 float scale, int B, int S, int H, int KV,
                                 int D, int R, int dtype,
                                 cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || KV <= 0 || H % KV ||
      R <= 0 || R % kTile || KV * ((H / KV + kHeads - 1) / kHeads) > 65535 ||
      (S + R - 1) / R > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, lengths, part, tickets, out, lse,
                             scale, B, S, H, KV, D, R, stream);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, lengths, part, tickets, out,
                                     lse, scale, B, S, H, KV, D, R, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
