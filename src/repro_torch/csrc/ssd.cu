// Chunked Mamba-2 SSD scan.  For every batch row b and head h (group
// g = h / (H / G)), over chunks of Q tokens in order, with the (N, P) state
// S carried from chunk to chunk (zero before the first):
//   cums[k] = sum_{j <= k} dt[j] * A[h]                (within the chunk)
//   y[i]    = sum_{k <= i} (C[i] . B[k]) e(cums[i] - cums[k]) dt[k] x[k]
//           + (C[i] e(cums[i])) S
//   S       = e(cums[Q-1]) S + sum_k (B[k] e(cums[Q-1] - cums[k]) dt[k]) x[k]^T
// where e(v) = exp(clip(v, -60, 0)).  f32 throughout; y is rounded to x's
// dtype once, the final state is returned in f32.  Rows past L count as
// zeros with dt = 0, as the reference's zero padding: they add nothing.
//
// Replaces the TPU kernel _ssd_kernel (src/repro/kernels/ssd/ssd.py:25):
// every layer's prefill of mamba2-2.7b, x (B, L, 80, 64) bf16, dt (B, L, 80)
// f32, B and C (B, L, 1, 128) bf16, Q = min(256, L).
//
// What bounds it on an H100: operations.  The function needs, per chunk of
// q rows, C . B^T once per group over the causal triangle (q^2/2 x N), and
// per head the causal M @ x (q^2/2 x P), the state update (q x N x P) and,
// from the second chunk on, the state term (q x N x P): at a 200-token
// prefill 473 MFLOP against 6.9 MB (chip_smoke.ssd_work), some 69 flops a
// byte, above the 20 at which FP32 FMA (67 TFLOP/s, no tensor cores: the
// function is f32) stops waiting on memory.
//
// Design: the chunk-parallel form of the scan (Mamba-2, section 6).  Its
// stages, in blocks of four kinds:
//   - C.B^T blocks: a 64 x 64 (or 32 x 64) tile of C . B^T per (b, g,
//     chunk), once per group and not once per head, on and below the
//     diagonal, key-major into an f32 scratch (Qp x Qp a chunk, Qp = Q
//     rounded up to 64: 256 KB at Q = 256, which stays in L2);
//   - state blocks: per (b, h, chunk, slice of the state's N rows), the
//     chunk's own contribution dS = (B o w)^T x over its Q keys, with
//     w[k] = e(cums[Q-1] - cums[k]) dt[k]; no chunk waits for another, and
//     with one chunk dS is the final state (lam * 0 + dS);
//   - the state pass (two chunks or more): per state entry, over the
//     chunks in order, S = lam S + dS, lam = e(cums[Q-1]), writing the
//     state that enters each chunk over its dS: the only sequential part;
//   - y blocks: per (b, h, chunk, tile of rows), y = M @ x with M = C.B^T
//     o e(cums_i - cums_k) o dt_k masked to k <= i, plus (C o e(cums)) @
//     S_in from the second chunk on (the first starts from a zero state).
// A state or y block makes its head's decays itself: cums as one thread's
// sequential f32 sum (a product rounded, then a sum rounded, as the plain
// version's _cumsum_seq), while its first tiles are in flight.  So state
// blocks need nothing but the caller's inputs, and only y blocks wait.  The
// launches, on the caller's stream, each after the first launched
// programmatically dependent on the one before (griddepcontrol):
//   one chunk:    ssd_cb_kernel (C.B^T), then ssd_front_kernel (chunk 0's
//                 y blocks beside the state blocks, which start at once);
//   more chunks:  ssd_front_kernel (C.B^T beside every chunk's state
//                 blocks), ssd_pass_kernel, ssd_y_kernel (every chunk's y).
// Every product is register-tiled FP32 FMA: a thread owns 8 rows x 4
// columns of its block's output and reads 8 + 4 values a step as three
// float4 loads from shared memory (32 FMAs to 3 loads; 16 lanes of a warp
// share the 8-row operand).  The operands stream through a two-stage ring
// of cp.async copies of the raw tiles (csrc/cp_async.cuh), which a
// conversion pass turns into the f32 operands (bf16 widened, w, the decays
// and the causal mask applied, transposed where the product needs it).
// No atomics, a fixed order, and a launch geometry computed from the shape
// (kernels/ssd/ssd.py: row_tile, state_slice, ssd_grids, scratch_numel):
// the result is deterministic.
//
// Summation order.  Every sum keeps the order of this kernel's first
// version: C . B^T a fmaf chain over n = 0..N-1; M @ x a fmaf chain over
// the keys in ascending order (keys past row i add fmaf(0, x, .)); the
// state term a fmaf chain over n; dS a fmaf chain over the keys in
// ascending order; S = lam S + dS with one rounding each (__fmul_rn,
// __fadd_rn); y = (M @ x) + (state term).  So for finite inputs the
// outputs are bit-equal to that version's; the redesign moved no sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kKB = 32;             // the K step of every product
constexpr int kPB = 64;             // head-dim columns a tile (P <= 64)
constexpr int kCBT = 64;            // C.B^T tiles are kCBT x kCBT

constexpr int kPassThreads = 256;   // the state pass
constexpr int kStages = 2;          // cp.async ring depth
constexpr int kMinBlocks = 4;       // blocks an SM of the tile kernels
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxN = 256;

struct Shape {
  int B, L, H, P, G, N, Q, Qp, nc;
};

// the wrapper's f32 scratch, cut as scratch_numel in kernels/ssd/ssd.py
struct Scratch {
  float* lam;   // (B, nc, H): e(cums[Q-1]), for the state pass
  float* cb;    // (B, G, nc, Qp, Qp): C.B^T key-major, cb[k][i], the
                //   tiles with k's tile <= i's
  float* st;    // (B, H, nc, N, P): dS, then the state entering the chunk
};

__host__ __device__ constexpr size_t align64(size_t n) {
  return (n + 63) / 64 * 64;
}

// a raw tile's row in elements: kKB or kPB columns plus 16 bytes, so rows
// stay 16-byte aligned for cp.async
template <typename T, int COLS>
__host__ __device__ constexpr int raw_ld() {
  return COLS + 16 / (int)sizeof(T);
}

template <typename T, int TR>
__host__ __device__ constexpr size_t cb_smem() {
  return kStages * (TR + kCBT) * raw_ld<T, kKB>() * sizeof(T) +
         (size_t)kKB * (TR + kCBT) * sizeof(float);
}

template <typename T, int NS>
__host__ __device__ constexpr size_t state_stage_bytes() {
  return kKB * (raw_ld<T, NS>() + raw_ld<T, kPB>()) * sizeof(T);
}

template <typename T, int NS>
__host__ __device__ constexpr size_t state_smem(int Qp) {
  return kStages * state_stage_bytes<T, NS>() +
         ((size_t)kKB * NS + kKB * kPB + 3 * (size_t)Qp) * sizeof(float);
}

template <typename T, int RT>
__host__ __device__ constexpr size_t y_stage_bytes() {
  // C.B^T (f32, key-major) and x, or C and the state (f32)
  return (kKB * raw_ld<float, RT>() * sizeof(float) +
          kKB * raw_ld<T, kPB>() * sizeof(T)) >
                 (RT * raw_ld<T, kKB>() * sizeof(T) +
                  kKB * raw_ld<float, kPB>() * sizeof(float))
             ? kKB * raw_ld<float, RT>() * sizeof(float) +
                   kKB * raw_ld<T, kPB>() * sizeof(T)
             : RT * raw_ld<T, kKB>() * sizeof(T) +
                   kKB * raw_ld<float, kPB>() * sizeof(float);
}

// with `stash`, room for M @ x while the state term runs (chunks >= 1)
template <typename T, int RT>
__host__ __device__ constexpr size_t y_smem(int Qp, bool stash) {
  return kStages * y_stage_bytes<T, RT>() +
         ((size_t)kKB * RT + kKB * kPB + RT + 2 * (size_t)Qp +
          (stash ? (size_t)RT * kPB : 0)) * sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);    // round to nearest even, as torch's cast
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// exp(clip(v, -60, 0)); a NaN stays a NaN, as with jnp.clip
__device__ __forceinline__ float clip_exp(float v) {
  return expf(v < -60.0f ? -60.0f : (v > 0.0f ? 0.0f : v));
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Copy a ROWS x COLS tile of T (row r at g + r * gld) into shared memory
// (row stride sld), zeros for rows >= rows_ok and columns >= cols_ok: by
// 16-byte cp.async copies where every copy is aligned, by 4-byte ones where
// those are, else by plain loads.  `safe` is a valid address the zero-fill
// copies name (they read nothing).
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, int sld, const T* g,
                                          size_t gld, int rows_ok,
                                          int cols_ok, const void* safe,
                                          int tid) {
  constexpr int V16 = 16 / (int)sizeof(T), V4 = 4 / (int)sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const size_t rb = gld * sizeof(T);
  const bool full = cols_ok >= COLS;
  const float* zs = static_cast<const float*>(safe);
  if (a % 16 == 0 && rb % 16 == 0 && (full || cols_ok % V16 == 0)) {
    constexpr int per = COLS / V16;
    for (int i = tid; i < ROWS * per; i += THREADS) {
      const int r = i / per, c = (i % per) * V16;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(reinterpret_cast<float*>(s + r * sld + c),
                 ok ? reinterpret_cast<const float*>(g + r * gld + c) : zs,
                 ok);
    }
  } else if (a % 4 == 0 && rb % 4 == 0 && (full || cols_ok % V4 == 0)) {
    constexpr int per = COLS / V4;
    for (int i = tid; i < ROWS * per; i += THREADS) {
      const int r = i / per, c = (i % per) * V4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(reinterpret_cast<float*>(s + r * sld + c),
                ok ? reinterpret_cast<const float*>(g + r * gld + c) : zs,
                ok);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      s[r * sld + c] = (r < rows_ok && c < cols_ok) ? g[r * gld + c]
                                                    : zero_of<T>();
    }
  }
}

// The ring of kStages stages: issue(j, stage) starts the copies of step j,
// convert(j, stage) turns the landed raw tiles into the f32 operands,
// compute() runs the step's FMAs; prologue() runs once, after the first
// steps' copies are issued.  Steps j + 1 .. j + kStages - 1 are in
// flight while step j computes; one barrier after a step's copies land,
// one after its conversion.
template <typename Issue, typename Convert, typename Compute,
          typename Prologue>
__device__ __forceinline__ void ring(int steps, Issue issue, Convert convert,
                                     Compute compute, Prologue prologue) {
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < steps) issue(j, j);
    cp_async_commit();
  }
  prologue();               // while the first copies fly
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // step j landed; step j - 1's stage is free
    if (j + kStages - 1 < steps)
      issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    convert(j, j % kStages);
    __syncthreads();
    compute();
  }
}

// A thread (tm, tn) of a BM x kPB block tile owns 8 rows, trow(tm, 0..7),
// two runs of four half a tile apart, and the 4 columns tn * 4 .. + 3: a
// block has BM * 2 threads, and each of the three float4 loads of a step
// is conflict-free across the warp (16 lanes share each row load).
constexpr int kColGroups = kPB / 4;

template <int BM>
__host__ __device__ constexpr int tile_threads() {
  return BM / 8 * kColGroups;
}

template <int BM>
__device__ __forceinline__ int trow(int tm, int r) {
  return r < 4 ? tm * 4 + r : BM / 2 + tm * 4 + r - 4;
}


// acc[r][c] = fmaf(As[k][trow(r)], Bs[k][4 tn + c], acc[r][c]) for
// k = 0 .. kKB - 1 in order: 32 FMAs to three float4 loads; As is kKB x BM,
// Bs kKB x kPB
template <int BM>
__device__ __forceinline__ void fma_step(const float* As, const float* Bs,
                                         float (&acc)[8][4], int tm,
                                         int tn) {
#pragma unroll 4
  for (int k = 0; k < kKB; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * BM + tm * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * BM + BM / 2 + tm * 4);
    const float4 bv = *reinterpret_cast<const float4*>(Bs + k * kPB + tn * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// The decays of head h, chunk c, over its rows [0, kn): ds[k] = dt (0 past
// L), then one thread's sequential f32 sum cs[k] = cums[k] (a product
// rounded, then a sum rounded, as the plain version's _cumsum_seq), 8 rows
// of dt read ahead of the chain.  Every block that needs them makes its
// own; they cost one pass over kn <= Q rows.
template <int THREADS>
__device__ __forceinline__ void chunk_decays(const float* __restrict__ dt,
                                             const float* __restrict__ A,
                                             const Shape& s, int b, int c,
                                             int h, int kn, float* cs,
                                             float* ds) {
  const int tid = threadIdx.x, l0 = c * s.Q, rows = min(s.Q, s.L - l0);
  const float* g = dt + ((size_t)b * s.L + l0) * s.H + h;
  for (int k = tid; k < kn; k += THREADS)
    ds[k] = k < rows ? g[(size_t)k * s.H] : 0.0f;
  __syncthreads();
  if (tid == 0) {
    const float a = A[h];
    float run = 0.0f;
    for (int k = 0; k < kn; k += 8) {
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = k + u < kn ? ds[k + u] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run = __fadd_rn(run, __fmul_rn(d[u], a));
        if (k + u < kn) cs[k + u] = run;
      }
    }
  }
  __syncthreads();
}

// The TR x kCBT tile of C.B^T of group g, chunk c, with rows [ti TR,
// (ti + 1) TR) and keys [tk kCBT, (tk + 1) kCBT), tk kCBT < (ti + 1) TR
template <typename T, int TR>
__device__ __forceinline__ void cb_block(const T* __restrict__ Cm,
                                         const T* __restrict__ Bm,
                                         const Shape& s, const Scratch& sc,
                                         int b, int g, int c, int ti, int tk,
                                         unsigned char* smem) {
  constexpr int kThreads = tile_threads<TR>();
  constexpr int RLD = raw_ld<T, kKB>();
  constexpr int kStage = (TR + kCBT) * RLD;       // elements: C, then B
  T* raw = reinterpret_cast<T*>(smem);
  float* As = reinterpret_cast<float*>(smem + kStages * kStage * sizeof(T));
  float* Bs = As + kKB * TR;
  const int tid = threadIdx.x, tm = tid / kColGroups, tn = tid % kColGroups;
  const int l0 = c * s.Q, rows = min(s.Q, s.L - l0);
  const int i0 = ti * TR, k0 = tk * kCBT;
  const size_t ld = (size_t)s.G * s.N;
  const T* gc = Cm + ((size_t)b * s.L + l0 + i0) * ld + (size_t)g * s.N;
  const T* gb = Bm + ((size_t)b * s.L + l0 + k0) * ld + (size_t)g * s.N;
  const int rc = rows - i0, rbk = rows - k0;
  float acc[8][4] = {};
  ring(
      (s.N + kKB - 1) / kKB,
      [&](int j, int st) {
        T* r = raw + st * kStage;
        load_tile<T, TR, kKB, kThreads>(r, RLD, gc + j * kKB, ld, rc,
                                        s.N - j * kKB, Cm, tid);
        load_tile<T, kCBT, kKB, kThreads>(r + TR * RLD, RLD, gb + j * kKB,
                                          ld, rbk, s.N - j * kKB, Bm, tid);
      },
      [&](int, int st) {
        const T* rcs = raw + st * kStage;
        const T* rbs = rcs + TR * RLD;
        for (int i = tid; i < TR * kKB; i += kThreads) {
          const int m = i % TR, kk = i / TR;
          As[kk * TR + m] = to_f32(rcs[m * RLD + kk]);
        }
        for (int i = tid; i < kCBT * kKB; i += kThreads) {
          const int m = i % kCBT, kk = i / kCBT;
          Bs[kk * kCBT + m] = to_f32(rbs[m * RLD + kk]);
        }
      },
      [&] { fma_step<TR>(As, Bs, acc, tm, tn); }, [] {});
  // stored key-major, cb[k][i], so a y block reads its keys' rows whole
  float* out = sc.cb + (((size_t)b * s.G + g) * s.nc + c) * s.Qp * s.Qp +
               (size_t)k0 * s.Qp + i0;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    float* o = out + (size_t)(tn * 4 + cc) * s.Qp;
    *reinterpret_cast<float4*>(o + trow<TR>(tm, 0)) =
        make_float4(acc[0][cc], acc[1][cc], acc[2][cc], acc[3][cc]);
    *reinterpret_cast<float4*>(o + trow<TR>(tm, 4)) =
        make_float4(acc[4][cc], acc[5][cc], acc[6][cc], acc[7][cc]);
  }
}

// dS = (B o w)^T x of (b, h, chunk) for state rows [n0, n0 + NS); with
// one chunk, the final state lam * 0 + dS
template <typename T, int NS>
__device__ __forceinline__ void state_block(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    float* __restrict__ state, const Shape& s, const Scratch& sc, int idx,
    unsigned char* smem) {
  constexpr int kThreads = tile_threads<NS>();
  constexpr int BLD = raw_ld<T, NS>(), XLD = raw_ld<T, kPB>();
  constexpr int kStage = kKB * (BLD + XLD);       // elements
  T* raw = reinterpret_cast<T*>(smem);
  float* As = reinterpret_cast<float*>(smem + kStages * kStage * sizeof(T));
  float* Bs = As + kKB * NS;
  float* ws = Bs + kKB * kPB;
  const int nsl = (s.N + NS - 1) / NS;
  const int n0 = (idx % nsl) * NS;
  idx /= nsl;
  const int h = idx % s.H;
  idx /= s.H;
  const int c = idx % s.nc, b = idx / s.nc;
  const int g = h / (s.H / s.G);
  const int tid = threadIdx.x, tm = tid / kColGroups, tn = tid % kColGroups;
  const int l0 = c * s.Q, rows = min(s.Q, s.L - l0);
  const size_t bld = (size_t)s.G * s.N, xld = (size_t)s.H * s.P;
  const T* gb = Bm + ((size_t)b * s.L + l0) * bld + (size_t)g * s.N + n0;
  const T* gx = x + ((size_t)b * s.L + l0) * xld + (size_t)h * s.P;
  // no wait on the launch before: this block reads only the caller's
  // inputs; its decays are made while its first tiles fly
  float* cs = ws + s.Qp;
  float* ds = cs + s.Qp;
  float lam = 0.0f;
  auto decays = [&] {
    chunk_decays<kThreads>(dt, A, s, b, c, h, s.Q, cs, ds);
    const float last = cs[s.Q - 1];
    for (int k = tid; k < s.Qp; k += kThreads)
      ws[k] = k < s.Q ? clip_exp(last - cs[k]) * ds[k] : 0.0f;
    lam = clip_exp(last);
    if (s.nc > 1 && n0 == 0 && tid == 0)          // for the state pass
      sc.lam[((size_t)b * s.nc + c) * s.H + h] = lam;
  };
  float acc[8][4] = {};
  ring(
      (s.Q + kKB - 1) / kKB,
      [&](int j, int st) {
        T* rbt = raw + st * kStage;
        load_tile<T, kKB, NS, kThreads>(rbt, BLD, gb + (size_t)j * kKB * bld,
                                        bld, rows - j * kKB, s.N - n0, Bm,
                                        tid);
        load_tile<T, kKB, kPB, kThreads>(rbt + kKB * BLD, XLD,
                                         gx + (size_t)j * kKB * xld, xld,
                                         rows - j * kKB, s.P, x, tid);
      },
      [&](int j, int st) {
        const T* rbt = raw + st * kStage;
        const T* rxt = rbt + kKB * BLD;
        for (int i = tid; i < kKB * NS; i += kThreads) {
          const int kk = i / NS, n = i % NS;
          As[i] = to_f32(rbt[kk * BLD + n]) * ws[j * kKB + kk];
        }
        for (int i = tid; i < kKB * kPB; i += kThreads)
          Bs[i] = to_f32(rxt[(i / kPB) * XLD + i % kPB]);
      },
      [&] { fma_step<NS>(As, Bs, acc, tm, tn); }, decays);
  const size_t bh = (size_t)b * s.H + h;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + trow<NS>(tm, r);
    if (n >= s.N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tn * 4 + j;
      if (p >= s.P) continue;
      if (s.nc == 1)
        state[(bh * s.N + n) * s.P + p] =
            __fadd_rn(__fmul_rn(lam, 0.0f), acc[r][j]);
      else
        sc.st[((bh * s.nc + c) * s.N + n) * s.P + p] = acc[r][j];
    }
  }
}

// The state pass (two chunks or more): per state entry, S = lam S + dS
// over the chunks in order; the state entering chunk c replaces its dS
__global__ void __launch_bounds__(kPassThreads)
    ssd_pass_kernel(float* __restrict__ state, Shape s, Scratch sc) {
  pdl_trigger();
  const size_t i = (size_t)blockIdx.x * kPassThreads + threadIdx.x;
  const size_t np = (size_t)s.N * s.P;
  if (i >= (size_t)s.B * s.H * np) return;
  const size_t bh = i / np, e = i % np;
  const int h = (int)(bh % s.H), b = (int)(bh / s.H);
  pdl_wait();                                      // every dS
  float* p = sc.st + bh * s.nc * np + e;
  const float* lam = sc.lam + (size_t)b * s.nc * s.H + h;
  float S = 0.0f;
  for (int c0 = 0; c0 < s.nc; c0 += 8) {           // 8 chunks' loads at once
    float d[8], l[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      d[u] = c0 + u < s.nc ? p[(size_t)(c0 + u) * np] : 0.0f;
      l[u] = c0 + u < s.nc ? lam[(size_t)(c0 + u) * s.H] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u >= s.nc) break;
      if (c0 + u > 0) p[(size_t)(c0 + u) * np] = S;
      S = __fadd_rn(__fmul_rn(l[u], S), d[u]);
    }
  }
  state[i] = S;
}

// Rows [i0, i0 + RT) of y of (b, h, chunk), block idx of the chunks
// [c0, c0 + ncy).  M @ x first; from the second chunk on, that sum waits in
// shared memory while the registers take the state term, and y is their
// sum.
template <typename T, int RT>
__device__ __forceinline__ void y_block(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Cm,
    T* __restrict__ y, const Shape& s, const Scratch& sc, int idx, int c0,
    int ncy, unsigned char* smem) {
  constexpr int kThreads = tile_threads<RT>();
  constexpr int MLD = raw_ld<float, RT>(), XLD = raw_ld<T, kPB>();
  constexpr int CLD = raw_ld<T, kKB>(), SLD = raw_ld<float, kPB>();
  constexpr size_t kStage = y_stage_bytes<T, RT>();
  float* As = reinterpret_cast<float*>(smem + kStages * kStage);
  float* Bs = As + kKB * RT;
  float* es = Bs + kKB * kPB;                      // RT: e(cums_i)
  float* cs = es + RT;                             // cums, Qp
  float* ds = cs + s.Qp;                           // dt, Qp
  float* ys = ds + s.Qp;                           // RT x kPB: M @ x
  // every head's longest rows first, then every head's next: a block's
  // neighbours in the launch order (which the card spreads over its SMs)
  // are other heads' tiles of the same length, not the same head's others
  const int nrt = (s.Q + RT - 1) / RT;
  const int h = idx % s.H;
  idx /= s.H;
  const int rt = nrt - 1 - idx % nrt;
  idx /= nrt;
  const int c = c0 + idx % ncy, b = idx / ncy;
  const int g = h / (s.H / s.G);
  const int l0 = c * s.Q, rows = min(s.Q, s.L - l0), i0 = rt * RT;
  if (i0 >= rows) return;                          // past L
  const int qn = min(RT, rows - i0);               // rows written
  const int kend = min(i0 + RT, s.Q);              // keys k < kend
  const int tid = threadIdx.x, tm = tid / kColGroups, tn = tid % kColGroups;
  const size_t xld = (size_t)s.H * s.P, bld = (size_t)s.G * s.N;
  const float* gm = sc.cb + (((size_t)b * s.G + g) * s.nc + c) * s.Qp * s.Qp +
                    i0;
  const T* gx = x + ((size_t)b * s.L + l0) * xld + (size_t)h * s.P;
  chunk_decays<kThreads>(dt, A, s, b, c, h, kend, cs, ds);
  pdl_wait();                                      // C.B^T, S_in
  float acc[8][4] = {};
  ring(
      (kend + kKB - 1) / kKB,
      [&](int j, int st) {
        unsigned char* base = smem + st * kStage;
        float* rm = reinterpret_cast<float*>(base);
        T* rx = reinterpret_cast<T*>(base + kKB * MLD * sizeof(float));
        load_tile<float, kKB, RT, kThreads>(
            rm, MLD, gm + (size_t)j * kKB * s.Qp, s.Qp, kKB, RT, sc.cb, tid);
        load_tile<T, kKB, kPB, kThreads>(rx, XLD, gx + (size_t)j * kKB * xld,
                                         xld, rows - j * kKB, s.P, x, tid);
      },
      [&](int j, int st) {
        const unsigned char* base = smem + st * kStage;
        const float* rm = reinterpret_cast<const float*>(base);
        const T* rx =
            reinterpret_cast<const T*>(base + kKB * MLD * sizeof(float));
        const int r = tid % RT, ii = i0 + r;       // this thread's row
        const float ci = cs[ii];
#pragma unroll 4
        for (int kk = tid / RT; kk < kKB; kk += kThreads / RT) {
          const int k = j * kKB + kk;
          As[kk * RT + r] =
              (k <= ii && ii < s.Q)
                  ? rm[kk * MLD + r] * clip_exp(ci - cs[k]) * ds[k]
                  : 0.0f;
        }
        for (int i = tid; i < kKB * kPB; i += kThreads)
          Bs[i] = to_f32(rx[(i / kPB) * XLD + i % kPB]);
      },
      [&] { fma_step<RT>(As, Bs, acc, tm, tn); }, [] {});

  if (c > 0) {                                     // the carried state's term
    const T* gc = Cm + ((size_t)b * s.L + l0 + i0) * bld + (size_t)g * s.N;
    const float* gs = sc.st + (((size_t)b * s.H + h) * s.nc + c) * s.N * s.P;
    for (int r = tid; r < RT; r += kThreads)
      es[r] = i0 + r < s.Q ? clip_exp(cs[i0 + r]) : 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ys[trow<RT>(tm, r) * kPB + tn * 4 + j] = acc[r][j];
        acc[r][j] = 0.0f;
      }
    ring(
        (s.N + kKB - 1) / kKB,
        [&](int j, int st) {
          unsigned char* base = smem + st * kStage;
          T* rc = reinterpret_cast<T*>(base);
          float* rs = reinterpret_cast<float*>(base + RT * CLD * sizeof(T));
          load_tile<T, RT, kKB, kThreads>(rc, CLD, gc + j * kKB, bld, qn,
                                          s.N - j * kKB, Cm, tid);
          load_tile<float, kKB, kPB, kThreads>(
              rs, SLD, gs + (size_t)j * kKB * s.P, s.P, s.N - j * kKB, s.P,
              sc.st, tid);
        },
        [&](int, int st) {
          const unsigned char* base = smem + st * kStage;
          const T* rc = reinterpret_cast<const T*>(base);
          const float* rs =
              reinterpret_cast<const float*>(base + RT * CLD * sizeof(T));
          for (int i = tid; i < kKB * RT; i += kThreads) {
            const int r = i % RT, nn = i / RT;
            As[nn * RT + r] = to_f32(rc[r * CLD + nn]) * es[r];
          }
          for (int i = tid; i < kKB * kPB; i += kThreads)
            Bs[i] = rs[(i / kPB) * SLD + i % kPB];
        },
        [&] { fma_step<RT>(As, Bs, acc, tm, tn); }, [] {});
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)    // (M @ x) + (state term), as before
        acc[r][j] = ys[trow<RT>(tm, r) * kPB + tn * 4 + j] + acc[r][j];
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = acc[r][j] + 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int rr = trow<RT>(tm, r);
    if (rr >= qn) continue;
    T* yr = y + ((size_t)b * s.L + l0 + i0 + rr) * xld + (size_t)h * s.P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tn * 4 + j;
      if (p < s.P) store(yr + p, acc[r][j]);
    }
  }
}

// The C.B^T tiles with rows of TR: row tile ti holds key tiles
// 0 .. ti TR / kCBT
template <int TR>
__host__ __device__ constexpr int cb_tiles(int Qp) {
  int n = 0;
  for (int ti = 0; ti < Qp / TR; ++ti) n += ti * TR / kCBT + 1;
  return n;
}

// C.B^T tile idx of every (b, g, chunk)'s cb_tiles<BM>
template <typename T, int BM>
__device__ __forceinline__ void cb_tile(const T* __restrict__ Bm,
                                        const T* __restrict__ Cm,
                                        const Shape& s, const Scratch& sc,
                                        int idx, unsigned char* smem) {
  const int ntri = cb_tiles<BM>(s.Qp);
  int t = idx % ntri;
  idx /= ntri;
  const int c = idx % s.nc;
  idx /= s.nc;
  const int g = idx % s.G, b = idx / s.G;
  int ti = 0;
  while (t >= ti * BM / kCBT + 1) {
    t -= ti * BM / kCBT + 1;
    ++ti;
  }
  cb_block<T, BM>(Cm, Bm, s, sc, b, g, c, ti, t, smem);
}

// One chunk's first launch: the C.B^T tiles alone
template <typename T, int BM>
__global__ void __launch_bounds__(tile_threads<BM>(), kMinBlocks)
    ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  Shape s, Scratch sc) {
  pdl_trigger();
  extern __shared__ __align__(16) unsigned char smem[];
  cb_tile<T, BM>(Bm, Cm, s, sc, blockIdx.x, smem);
}

// The front launch: blocks [0, n_cb) make C.B^T tiles, the next n_y the y
// blocks of chunk 0 (after the launch before, which made C.B^T), the rest
// the state blocks (they need only the caller's inputs)
template <typename T, int BM>
__global__ void __launch_bounds__(tile_threads<BM>(), kMinBlocks)
    ssd_front_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, T* __restrict__ y,
                     float* __restrict__ state, Shape s, Scratch sc,
                     int n_cb, int n_y) {
  pdl_trigger();
  extern __shared__ __align__(16) unsigned char smem[];
  int idx = blockIdx.x;
  if (idx >= n_cb + n_y) {
    state_block<T, BM>(x, dt, A, Bm, state, s, sc, idx - n_cb - n_y, smem);
    return;
  }
  if (idx >= n_cb) {
    y_block<T, BM>(x, dt, A, Cm, y, s, sc, idx - n_cb, 0, 1, smem);
    return;
  }
  cb_tile<T, BM>(Bm, Cm, s, sc, idx, smem);
}

// the y blocks of every chunk (two chunks or more)
template <typename T, int RT>
__global__ void __launch_bounds__(tile_threads<RT>(), kMinBlocks)
    ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Cm,
                 T* __restrict__ y, Shape s, Scratch sc) {
  pdl_trigger();
  extern __shared__ __align__(16) unsigned char smem[];
  y_block<T, RT>(x, dt, A, Cm, y, s, sc, blockIdx.x, 0, s.nc, smem);
}

template <typename K, typename... Args>
cudaError_t launch_dependent(K kernel, size_t grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int BM>
size_t front_smem(int Qp) {
  const size_t a = cb_smem<T, BM>(), b = state_smem<T, BM>(Qp),
               c = y_smem<T, BM>(Qp, false);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// One chunk: the C.B^T tiles, then chunk 0's y blocks beside the state
// blocks (both of BM = RT rows).  Two chunks or more: the C.B^T tiles
// beside the state blocks (NS rows), the state pass, then the y blocks of
// every chunk (RT rows).
template <typename T, int NS, int RT>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, T* y, float* state, const Shape& s,
           const Scratch& sc, cudaStream_t stream) {
  constexpr int BM = NS;
  const size_t n_cb = (size_t)s.B * s.G * s.nc * cb_tiles<BM>(s.Qp);
  const size_t n_st = (size_t)s.B * s.nc * s.H * ((s.N + BM - 1) / BM);
  const size_t n_y0 = (size_t)s.B * s.H * ((s.Q + BM - 1) / BM);
  const size_t n_pass =
      ((size_t)s.B * s.H * s.N * s.P + kPassThreads - 1) / kPassThreads;
  const size_t n_y = (size_t)s.B * s.nc * s.H * ((s.Q + RT - 1) / RT);
  const size_t smem1 = front_smem<T, BM>(s.Qp);
  const size_t smem3 = y_smem<T, RT>(s.Qp, true);
  const size_t lim = 0x7fffffff;
  if (n_cb + n_y0 + n_st > lim || n_pass > lim || n_y > lim ||
      smem1 > (size_t)kMaxSmem || smem3 > (size_t)kMaxSmem ||
      (s.nc == 1 && NS != RT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_front_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const unsigned threads = tile_threads<BM>();
  if (s.nc == 1) {
    err = cudaFuncSetAttribute(ssd_cb_kernel<T, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cb_smem<T, BM>());
    if (err != cudaSuccess) return (int)err;
    ssd_cb_kernel<T, BM><<<(unsigned)n_cb, threads, cb_smem<T, BM>(),
                           stream>>>(Bm, Cm, s, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dependent(ssd_front_kernel<T, BM>, n_y0 + n_st,
                                 threads, smem1, stream, x, dt, A, Bm, Cm,
                                 y, state, s, sc, 0, (int)n_y0);
  }
  ssd_front_kernel<T, BM><<<(unsigned)(n_cb + n_st), threads, smem1,
                            stream>>>(x, dt, A, Bm, Cm, y, state, s, sc,
                                      (int)n_cb, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_dependent(ssd_pass_kernel, n_pass, kPassThreads, 0, stream,
                         state, s, sc);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(ssd_y_kernel<T, RT>, n_y, tile_threads<RT>(),
                               smem3, stream, x, dt, A, Cm, y, s, sc);
}

template <typename T>
int launch_tiles(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, void* y, float* state,
                 const Shape& s, const Scratch& sc, int rows, int nslice,
                 cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  T* yt = static_cast<T*>(y);
  if (nslice == 32 && rows == 32)
    return launch<T, 32, 32>(xt, dt, A, bt, ct, yt, state, s, sc, stream);
  if (nslice == 32 && rows == 64)
    return launch<T, 32, 64>(xt, dt, A, bt, ct, yt, state, s, sc, stream);
  if (nslice == 64 && rows == 32)
    return launch<T, 64, 32>(xt, dt, A, bt, ct, yt, state, s, sc, stream);
  if (nslice == 64 && rows == 64)
    return launch<T, 64, 64>(xt, dt, A, bt, ct, yt, state, s, sc, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y (Bb, L, H, P) and Bm, Cm (Bb, L, G, N) contiguous in one dtype
// (0 = float32, 1 = bfloat16); dt (Bb, L, H), A (H,) and state (Bb, H, N, P)
// float32; Q the chunk length (1 <= Q <= L); scratch float32 of
// scratch_numel(...) words (kernels/ssd/ssd.py); rows the rows of y a y
// block computes and nslice the state rows a state block computes (32 or
// 64; with one chunk both kinds share a launch, and nslice == rows).
extern "C" int repro_ssd(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, void* y, float* state,
                         float* scratch, int Bb, int L, int H, int P, int G,
                         int N, int Q, int rows, int nslice, int dtype,
                         cudaStream_t stream) {
  if (scratch == nullptr || Bb <= 0 || L <= 0 || H <= 0 || P <= 0 ||
      P > kPB || G <= 0 || H % G || N <= 0 || N > kMaxN || Q <= 0 || Q > L)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = Bb, s.L = L, s.H = H, s.P = P, s.G = G, s.N = N, s.Q = Q;
  s.Qp = (Q + kCBT - 1) / kCBT * kCBT;
  s.nc = (L + Q - 1) / Q;
  Scratch sc;
  sc.lam = scratch;
  sc.cb = sc.lam + align64((size_t)Bb * s.nc * H);
  sc.st = sc.cb + align64((size_t)Bb * G * s.nc * s.Qp * s.Qp);
  switch (dtype) {
    case 0:
      return launch_tiles<float>(x, dt, A, Bm, Cm, y, state, s, sc, rows,
                                 nslice, stream);
    case 1:
      return launch_tiles<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, s, sc,
                                         rows, nslice, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
