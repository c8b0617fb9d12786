// Batched one-token GQA decode attention: for every slot b and query head h,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G]) . v[b, s, h / G]
// over the cache positions s < lengths[b], G = H / KV query heads sharing
// one KV head.  q arrives pre-scaled by D^-0.5 in its own dtype (the
// wrapper does it, as the reference does); scores, the softmax and every
// sum are f32, and the output is written in q's dtype.  A slot of length 0
// attends uniformly over all S positions (the reference masks every score
// to the same -1e30, so its softmax is uniform): its output is the mean of
// v.
//
// Replaces the TPU kernel _decode_kernel (src/repro/kernels/decode_attn/
// decode_attn.py:26), the serving engine's hot spot: one launch per layer
// per decode step, q (B, 1, H, D), caches (B, S, KV, D) in f32 or bf16.
//
// What bounds it on an H100: bytes.  Each valid K and V element is read
// once and takes 2 flops per query head of its group (G = 3 for smollm-360m
// and llama3.2-3b), far below the ~295 flops a byte at which the card
// stops being bound by memory.  The TPU kernel walked a sequential grid
// over S chunks with the running (max, sum, acc) in scratch; here one block
// owns one (slot, KV head, chunk of up to 4 query heads) and reads only
// the slot's valid rows.  A row of D values is split over D / 8 (bf16) or
// D / 4 (f32) lanes that each load 16 bytes, so a warp reads whole
// consecutive rows (coalesced), and each lane loads 4 rows of K and of V
// before it uses any, to keep loads in flight.  Each group of lanes keeps
// its own online softmax (running max, sum and f32 accumulator per query
// head); at the end the groups' states go to shared memory and are merged
// in a fixed order, so the result is deterministic (no atomics, no
// split-S).  The grid has B * KV blocks (40 for smollm's decode at batch
// 8), too few to fill 132 SMs: a split over S with a second merge pass,
// and tensor cores for the q.k products, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 4;      // query heads of one KV head per block
constexpr int kUnroll = 4;     // rows a lane group loads before using them
constexpr float kNegInf = -1e30f;

// 16 bytes of a row, unpacked to f32 (bf16 is the top half of an f32)
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& r, float (&f)[kVec]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& r, float (&f)[kVec]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int S, int H, int KV) {
  constexpr int kVec = Row<T>::kVec;
  constexpr int kLanes = D / kVec;              // lanes holding one row
  static_assert(D % kVec == 0 && kLanes >= 1 && kLanes <= 32 &&
                    32 % kLanes == 0,
                "a row must split evenly over a power-of-two lane group");
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kRows = kWarps * kRowsPerWarp;  // rows per block step

  __shared__ float s_m[kRows][kHeads];
  __shared__ float s_l[kRows][kHeads];
  __shared__ float s_acc[kRows][kHeads][D];

  const int G = H / KV;
  const int kvh = blockIdx.x % KV;
  const int g0 = (blockIdx.x / KV) * kHeads;
  const int ng = min(kHeads, G - g0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % kLanes;                // this lane's slice of a row
  const int grp = lane / kLanes;
  const int row = warp * kRowsPerWarp + grp;    // this group's state row
  const int len = lengths[b];
  const bool uniform = len <= 0;
  const int n = uniform ? S : min(len, S);

  const size_t head0 = (size_t)b * H + (size_t)kvh * G + g0;
  float qf[kHeads][kVec];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < ng) {
      Row<T>::unpack(*reinterpret_cast<const uint4*>(
                         q + (head0 + g) * D + sub * kVec),
                     qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qf[g][i] = 0.0f;
    }
  }
  float m[kHeads], l[kHeads], acc[kHeads][kVec];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.0f;
  }

  const size_t stride = (size_t)KV * D;         // one position to the next
  const size_t base = ((size_t)b * S * KV + kvh) * D + sub * kVec;
  const T* kp = k + base;
  const T* vp = v + base;
  // the trip count depends on the warp only, so every lane of a warp takes
  // part in each shuffle
  for (int s0 = warp * kRowsPerWarp; s0 < n; s0 += kRows * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + grp + u * kRows;
      if (s < n) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + s * stride));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + s * stride));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = s0 + grp + u * kRows < n;
      float kf[kVec], vf[kVec];
      Row<T>::unpack(kr[u], kf);
      Row<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot = fmaf(qf[g][i], kf[i], dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid) {
          const float sc = uniform ? 0.0f : dot;
          const float mn = fmaxf(m[g], sc);
          const float corr = expf(m[g] - mn);
          const float p = expf(sc - mn);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[g][i] = acc[g][i] * corr + p * vf[i];
          m[g] = mn;
        }
      }
    }
  }

  // merge the groups' online-softmax states in row order
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (sub == 0) {
      s_m[row][g] = m[g];
      s_l[row][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) s_acc[row][g][sub * kVec + i] = acc[g][i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ng * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float mx = kNegInf;
    for (int r = 0; r < kRows; ++r) mx = fmaxf(mx, s_m[r][g]);
    float den = 0.0f, num = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      const float w = expf(s_m[r][g] - mx);   // 0 for a row that read none
      den += s_l[r][g] * w;
      num += s_acc[r][g][d] * w;
    }
    Row<T>::store(out + (head0 + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int S, int H, int KV, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(KV * ((G + kHeads - 1) / kHeads), B);
  decode_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, H, KV);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int B, int S, int H, int KV, int D,
             cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch<T, 8>(q, k, v, lengths, out, B, S, H, KV, stream);
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, B, S, H, KV, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, B, S, H, KV, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, B, S, H, KV, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, B, S, H, KV, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out alike)
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v,
                                 const int* lengths, void* out, int B, int S,
                                 int H, int KV, int D, int dtype,
                                 cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, lengths, out, B, S, H, KV, D, stream);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, KV, D,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
