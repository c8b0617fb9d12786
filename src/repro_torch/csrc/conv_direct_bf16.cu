// bf16 conv stages of the direct conv layer (conv_direct.cu,
// conv_direct.cuh): the reference's bf16 model (bf16 x, bias and slab) on
// the tensor cores, and bf16 x with an f32 conv_bfp slab on the FFMA
// kernel of conv_direct.cuh.  A translation unit of its own, so that nvcc
// builds it beside the f32 instantiations.
//
// The tensor-core route (bf16 x and slab).  The reference widens both to
// f32 and sums einsum("jrwc,jck->rwk") in f32
// (src/repro/kernels/conv/direct.py).  A product of two bf16 values has at
// most 16 significant bits, so it is exact in f32: one bf16
// mma.sync.m16n8k16 with f32 accumulators computes the reference's
// products bit for bit, and only the order and rounding of the f32 sum
// differ.  What bounded the FFMA route in bf16 was its own arithmetic
// (one thread's FMA chain, 74-85x the bf16 bound at conv1/conv2) behind
// synchronous widening loads; here the products run at the tensor cores'
// rate and the copies keep bf16 as it is.
// - The GEMM: per group, rows the conv pixels (b, oy, ox), columns the
//   group's K output channels, the reduction over the taps in the slab's
//   row order (di, dj, c), c fastest.  A block of BM / 32 x 2 warps owns
//   a BM x BN tile (64 x 64, 64 x 96, 64 x 128 with 4 warps; 128 x 128
//   with 8), a warp 32 x BN / 2: two 16-row A fragments by ldmatrix.x4
//   and BN / 16 pairs of 8-column B fragments by ldmatrix.x4.trans (the
//   slab's rows are K x N, N contiguous) a k-step.
// - The order: each mma takes the 16 consecutive reduction indices of one
//   k-step (from a multiple of 16; the ragged tail zero-filled, conv1's
//   363 as 23 k-steps), the k-steps run in ascending order into one
//   accumulator an output, and there is no split-K and no atomic.  So an
//   output's bits do not depend on BM, BN or its place in the tile, and
//   the tile stays a knob that cannot change them.
// - The ring: kMmaStages k-steps of A (BM x 16) and B (16 x BN) bf16 in
//   shared memory.  Where C % 8 == 0 (conv2: 48 channels a group, each
//   pixel's tap 96 contiguous bytes at a 16-byte-aligned offset) every 8
//   reduction indices of a row are one 16-byte cp.async; where Kb % 8 ==
//   0 (conv1 and conv2) every 8 columns of a slab row are one.  conv1's C
//   = 3 gives 6-byte taps at any alignment, which no cp.async can copy,
//   so that gather loads a thread's 8 reduction indices of a k-step as
//   2-byte loads into registers before the products of the k-step three
//   ahead of it and stores them into the ring after those products, so
//   that the loads' latency hides behind the tensor cores; a per-block
//   table in shared memory maps each reduction index to its (di, dj, c)
//   and slab row, so the gather does no division.  Two other gathers
//   were no faster on the card (PERF.md §6): loads two k-steps ahead,
//   and each run of 8 inside one filter row, whose 33 values are
//   contiguous along W, as one window of 4-byte words.
// - Occupancy: 4 warps over a 64-row tile (64-128 registers, no spills),
//   30-45 KB of shared memory, so several blocks share an SM (the default
//   tiles: conv1 379 blocks of 64 x 96, conv2 368 of 64 x 64).
// - The epilogue: bias and ReLU in registers (epilogue.cuh's bias_relu on
//   the f32 sums).  Where one tile holds all of a pixel's channels (conv1
//   at BN >= 96) the block puts its f32 tile in shared memory and the
//   block's threads walk it over consecutive channels, each calling the
//   same lrn_at as the epilogue launch on the same values (so a tile with
//   BN < 96 gives the same bits) in a loop that is not unrolled: an
//   unrolled one inlines a powf an output a thread and took longer than
//   the GEMM.  y stays f32 (bf16 when narrow).
// - What bounds it now (PERF.md §6): not the products.  At conv1
//   the conv stage is the gather and the in-stage LRN's powf, at conv2
//   the LRN/pool launch (conv_direct_epilogue, unchanged: the LRN's powf
//   over 256 channels) takes about half the layer.
// - ABFT: the armed variant checks the bf16 slab's 16-bit checksum lanes
//   (abft.cuh) while the ring fills; the GEMM reads the same Cb rows, so
//   armed and unarmed outputs are bit-equal.
// Numerics against the f32 kernel on the widened inputs: both sum the
// same exact products, in another order and rounding (the tensor cores
// align each k-step's products and the accumulator to the largest
// exponent and truncate), so the two differ by f32 noise and the rounded
// outputs by at most one bf16 step (tests/test_torch_direct_bf16_mma.py
// models both sums on the CPU).  Zero-filled taps (padding, the ragged
// tail) are multiplied, not skipped, so a NaN weight still poisons.
#include "conv_direct.cuh"

namespace conv_direct_impl {

namespace {

// ---------------------------------------------------------------------------
// bf16 x on an f32 (conv_bfp) slab: the FFMA kernel with widening loads
// ---------------------------------------------------------------------------
template <int TM, int TN>
cudaError_t launch_bf16_armed(const ConvArgs& a, size_t smem,
                              cudaStream_t stream, const GemmPtrs& p) {
  return a.verdict
             ? launch_gemm<TM, TN, false, false, true, __nv_bfloat16,
                           float>(a, smem, stream, p)
             : launch_gemm<TM, TN, false, false, false, __nv_bfloat16,
                           float>(a, smem, stream, p);
}

// ---------------------------------------------------------------------------
// bf16 x on a bf16 slab: the tensor-core route
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a (16 x 16, row-major) b (16 x 8, column-major), bf16 operands, f32
// accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 pack8(const unsigned short (&e)[8]) {
  return make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                    e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
}

// Grid (ceil(M / BM), ceil(K / BN), g); 2 BM threads.  VA / VB: 16-byte
// cp.async copies of A (x) / B (the slab), else 2-byte loads staged
// through registers; ARMED: check the slab's checksum rows.  y is the f32
// conv map, or, with narrow set (no epilogue launch after), the bf16
// output.
template <int BM, int BN, bool VA, bool VB, bool ARMED>
__global__ void __launch_bounds__(mma_threads(BM))
conv_direct_mma(ConvArgs a, const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ slab,
                const __nv_bfloat16* __restrict__ bias,
                void* __restrict__ y, int narrow) {
  constexpr int NT = mma_threads(BM);
  constexpr int WN = BN / 2;                  // a warp's columns
  constexpr int NB = WN / 8;                  // its 8-column mma blocks
  constexpr int AS = kMmaApad;                // A row stride (bf16)
  constexpr int BS = BN + kMmaBpad;           // B row stride (bf16)
  constexpr int kBChunks = kBK * BN / 8;      // 8-column runs of B a step
  constexpr int kBPer = (kBChunks + NT - 1) / NT;
  constexpr size_t kRing =
      (size_t)kMmaStages * (BM * AS + kBK * BS) * sizeof(__nv_bfloat16);
  constexpr size_t kTile = (size_t)BM * BN * sizeof(float);
  static_assert(WN % 16 == 0, "ldmatrix.x4.trans loads two 8-column blocks");
  static_assert(NT == 2 * BM, "a thread gathers 8 of a row's 16 indices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kMmaStages * BM * AS;
  const int R = a.r * a.r * a.C;
  int* xtap = reinterpret_cast<int*>(smem_raw + (kRing > kTile ? kRing
                                                                : kTile));
  int* wrow = xtap + R;                       // slab offset of row k
  int* wcol = wrow + R;                       // of column c (-1: past K)
  const int M = a.B * a.out_h * a.out_w;
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const size_t tile_elems = (size_t)a.r * a.r * a.Cs * a.Kb;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ss = reinterpret_cast<const unsigned short*>(slab);

  for (int k = t; k < R; k += NT) {
    const int c = k % a.C, tap = k / a.C;
    xtap[k] = ((tap / a.r) << 24) | ((tap % a.r) << 16) | c;
    wrow[k] = (int)((c / a.Cb) * tile_elems
                    + ((size_t)tap * a.Cs + c % a.Cb) * a.Kb);
  }
  for (int c = t; c < BN; c += NT) {
    const int n = n0 + c;
    wcol[c] = n < a.K ? (int)(((size_t)grp * a.nkb + n / a.Kb) * a.ncb
                              * tile_elems + n % a.Kb)
                      : -1;
  }

  // the A row (one conv pixel) and the 8 of its 16 reduction indices a
  // k-step this thread gathers
  const int arow = t >> 1, ahalf = (t & 1) * 8;
  const int m = m0 + arow;
  const bool mvalid = m < M;
  const int hw = a.out_h * a.out_w;
  const int mb = mvalid ? m / hw : 0, mr = mvalid ? m % hw : 0;
  const int iy0 = (mr / a.out_w) * a.s - a.pad_h;
  const int ix0 = (mr % a.out_w) * a.s - a.pad_w;
  const unsigned short* xb = xs + (size_t)mb * a.H * a.W * a.Ct + grp * a.C;
  __syncthreads();

  // element k of this thread's row (0: a tap outside the input, the
  // ragged tail, a row past M), and its address for a 16-byte copy
  auto a_at = [&](int k, bool& ok) -> const unsigned short* {
    const int v = k < R ? xtap[k] : 0;
    const int iy = iy0 + (v >> 24), ix = ix0 + ((v >> 16) & 255);
    ok = mvalid && k < R && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    return ok ? xb + (iy * a.W + ix) * a.Ct + (v & 0xffff) : xs;
  };
  auto a_dst = [&](int stage) {
    return As + (stage * BM + arow) * AS + ahalf;
  };
  auto gather_a = [&](int k0) {
    unsigned short e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bool ok;
      const unsigned short* src = a_at(k0 + ahalf + i, ok);
      e[i] = ok ? __ldg(src) : (unsigned short)0;
    }
    return pack8(e);
  };
  // B's run q of a k-step: 8 columns of one slab row
  auto b_dst = [&](int stage, int q) {
    return Bs + (stage * kBK + q / (BN / 8)) * BS + (q % (BN / 8)) * 8;
  };
  auto gather_b = [&](int k0, int q) {
    const int kk = q / (BN / 8), col = (q % (BN / 8)) * 8, k = k0 + kk;
    unsigned short e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int wc = wcol[col + i];
      e[i] = k < R && wc >= 0 ? __ldg(ss + wc + wrow[k]) : (unsigned short)0;
    }
    return pack8(e);
  };
  // the cp.async copies of a k-step
  auto copy_async = [&](int stage, int k0) {
    if constexpr (VA) {
      bool ok;
      const unsigned short* src = a_at(k0 + ahalf, ok);
      cp_async16(reinterpret_cast<float*>(a_dst(stage)),
                 reinterpret_cast<const float*>(src), ok);
    }
    if constexpr (VB) {
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int q = t + NT * j;
        if (kBChunks % NT && q >= kBChunks) continue;
        const int kk = q / (BN / 8), col = (q % (BN / 8)) * 8;
        const int k = k0 + kk, wc = wcol[col];
        const bool ok = k < R && wc >= 0;
        cp_async16(reinterpret_cast<float*>(b_dst(stage, q)),
                   reinterpret_cast<const float*>(ok ? ss + wc + wrow[k]
                                                     : ss),
                   ok);
      }
    }
  };
  // the register-staged part of a k-step: loaded before the products of
  // the k-step kMmaStages - 1 before it, stored after them
  uint4 ra, rb[kBPer];
  auto fetch_regs = [&](int k0) {
    if constexpr (!VA) ra = gather_a(k0);
    if constexpr (!VB) {
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int q = t + NT * j;
        if (kBChunks % NT == 0 || q < kBChunks) rb[j] = gather_b(k0, q);
      }
    }
  };
  auto store_regs = [&](int stage) {
    if constexpr (!VA) *reinterpret_cast<uint4*>(a_dst(stage)) = ra;
    if constexpr (!VB) {
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int q = t + NT * j;
        if (kBChunks % NT == 0 || q < kBChunks)
          *reinterpret_cast<uint4*>(b_dst(stage, q)) = rb[j];
      }
    }
  };

  const int nsteps = (R + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nsteps) {
      copy_async(s, s * kBK);
      fetch_regs(s * kBK);
      store_regs(s);
    }
    cp_async_commit();
  }
  if constexpr (ARMED)          // its partial sums after the three tables
    abft_check_slab<unsigned short, NT / 32>(a, a.r * a.r, slab,
                                             (unsigned*)(wcol + BN));

  // warp (wm, wn) owns rows wm * 32 + [0, 32) and columns wn * WN + [0,
  // WN) of the tile: acc[i][j] the 16 x 8 block at rows 16 i, columns 8 j
  const int warp = t >> 5, lane = t & 31;
  const int wm = warp >> 1, wn = warp & 1;
  float acc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // ldmatrix row addresses: A rows lane % 16 at column (lane / 16) * 8; B
  // rows (reduction indices) lane % 16 at column (lane / 16) * 8
  const int a_off = (wm * 32 + (lane & 15)) * AS + (lane >> 4) * 8;
  const int b_off = (lane & 15) * BS + wn * WN + (lane >> 4) * 8;

  for (int kc = 0; kc < nsteps; ++kc) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int nxt = kc + kMmaStages - 1;
    if (nxt < nsteps) {
      copy_async(nxt % kMmaStages, nxt * kBK);
      fetch_regs(nxt * kBK);
    }
    cp_async_commit();
    const __nv_bfloat16* as = As + (kc % kMmaStages) * BM * AS + a_off;
    const __nv_bfloat16* bs = Bs + (kc % kMmaStages) * kBK * BS + b_off;
    // the k-step's fragments first, then its products
    unsigned af[2][4], bf[NB / 2][4];
    ldsm_x4(af[0], as);
    ldsm_x4(af[1], as + 16 * AS);
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) ldsm_x4_trans(bf[jj], bs + jj * 16);
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * jj], af[i], bf[jj][0], bf[jj][1]);
        mma_bf16(acc[i][2 * jj + 1], af[i], bf[jj][2], bf[jj][3]);
      }
    if (nxt < nsteps) store_regs(nxt % kMmaStages);
  }
  cp_async_wait<0>();

  // acc[i][j][e]: row wm * 32 + 16 i + lane / 4 (+ 8 for e >= 2), column
  // wn * WN + 8 j + 2 (lane % 4) + e % 2
  const bool nar = narrow;
  const int kf = a.g * a.K;
  const int r0 = wm * 32 + (lane >> 2), c0 = wn * WN + 2 * (lane & 3);
  if (lrn_in_gemm(a, BN)) {
    // the block's conv tile (BM pixels x K channels) in the rings' place,
    // then LRN across its channels, once per pixel and channel, the
    // block's threads over consecutive channels
    __syncthreads();
    float* yt = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 16 * i + 8 * (e >> 1);
          const int col = c0 + 8 * j + (e & 1);
          if (col < a.K)
            yt[row * BN + col] =
                bias_relu(acc[i][j][e], widen(bias[col]), a.relu);
        }
    __syncthreads();
    const int rows = min(BM, M - m0);
#pragma unroll 1
    for (int idx = t; idx < rows * a.K; idx += NT) {
      const int row = idx / a.K, col = idx % a.K;
      store_out(y, (size_t)(m0 + row) * kf + col,
                lrn_at(yt + row * BN, col, a.K, a), nar);
    }
    return;
  }
  const __nv_bfloat16* bp = bias + grp * a.K;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mo = m0 + r0 + 16 * i + 8 * h;
      if (mo >= M) continue;
      const size_t yo = (size_t)mo * kf + grp * a.K;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int n = n0 + c0 + 8 * j;       // even
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (!nar && a.K % 2 == 0) {          // n + 1 < K, 8-byte aligned
          if (n < a.K)
            *reinterpret_cast<float2*>(static_cast<float*>(y) + yo + n) =
                make_float2(bias_relu(v0, widen(bp[n]), a.relu),
                            bias_relu(v1, widen(bp[n + 1]), a.relu));
          continue;
        }
        if (n < a.K)
          store_out(y, yo + n, bias_relu(v0, widen(bp[n]), a.relu), nar);
        if (n + 1 < a.K)
          store_out(y, yo + n + 1, bias_relu(v1, widen(bp[n + 1]), a.relu),
                    nar);
      }
    }
}

template <int BM, int BN, bool VA, bool VB, bool ARMED>
cudaError_t launch_mma(const ConvArgs& a, size_t smem, cudaStream_t stream,
                       const GemmPtrs& p) {
  auto kernel = conv_direct_mma<BM, BN, VA, VB, ARMED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int M = a.B * a.out_h * a.out_w;
  dim3 grid((M + BM - 1) / BM, (a.K + BN - 1) / BN, a.g);
  kernel<<<grid, mma_threads(BM), smem, stream>>>(
      a, static_cast<const __nv_bfloat16*>(p.x),
      static_cast<const __nv_bfloat16*>(p.slab),
      static_cast<const __nv_bfloat16*>(p.bias), p.y, p.narrow);
  return cudaGetLastError();
}

template <int BM, int BN, bool ARMED>
cudaError_t launch_mma_copies(const ConvArgs& a, size_t smem, bool va,
                              bool vb, cudaStream_t stream,
                              const GemmPtrs& p) {
  if (va && vb) return launch_mma<BM, BN, true, true, ARMED>(a, smem,
                                                             stream, p);
  if (vb) return launch_mma<BM, BN, false, true, ARMED>(a, smem, stream, p);
  if (va) return launch_mma<BM, BN, true, false, ARMED>(a, smem, stream, p);
  return launch_mma<BM, BN, false, false, ARMED>(a, smem, stream, p);
}

template <int BM, int BN>
cudaError_t launch_mma_armed(const ConvArgs& a, size_t smem, bool va,
                             bool vb, cudaStream_t stream,
                             const GemmPtrs& p) {
  return a.verdict
             ? launch_mma_copies<BM, BN, true>(a, smem, va, vb, stream, p)
             : launch_mma_copies<BM, BN, false>(a, smem, va, vb, stream, p);
}

}  // namespace

cudaError_t launch_conv_stage_bf16(int tm, int tn, const ConvArgs& a,
                                   size_t smem, cudaStream_t stream,
                                   const GemmPtrs& p) {
  if (tm == 4 && tn == 4) return launch_bf16_armed<4, 4>(a, smem, stream, p);
  if (tm == 4 && tn == 6) return launch_bf16_armed<4, 6>(a, smem, stream, p);
  if (tm == 4 && tn == 8) return launch_bf16_armed<4, 8>(a, smem, stream, p);
  if (tm == 8 && tn == 4) return launch_bf16_armed<8, 4>(a, smem, stream, p);
  if (tm == 8 && tn == 6) return launch_bf16_armed<8, 6>(a, smem, stream, p);
  return cudaErrorInvalidValue;
}

cudaError_t launch_conv_stage_mma(int bm, int bn, const ConvArgs& a,
                                  size_t smem, bool va, bool vb,
                                  cudaStream_t stream, const GemmPtrs& p) {
  if (bm == 64 && bn == 64)
    return launch_mma_armed<64, 64>(a, smem, va, vb, stream, p);
  if (bm == 64 && bn == 96)
    return launch_mma_armed<64, 96>(a, smem, va, vb, stream, p);
  if (bm == 64 && bn == 128)
    return launch_mma_armed<64, 128>(a, smem, va, vb, stream, p);
  if (bm == 128 && bn == 128)
    return launch_mma_armed<128, 128>(a, smem, va, vb, stream, p);
  return cudaErrorInvalidValue;
}

}  // namespace conv_direct_impl
