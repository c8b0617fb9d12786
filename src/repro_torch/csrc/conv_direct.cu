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
// activations, slab and bias): the conv stage runs on the tensor cores
// (conv_direct_bf16.cu, whose head comment gives the design): bf16
// mma.sync over the same implicit GEMM, a cp.async ring that copies bf16
// as it is, f32 accumulators.  Its products are the reference's exactly
// (a bf16 x bf16 product is exact in f32), but it sums them in k-steps of
// 16 on the tensor cores, so it is no longer bit-equal to this kernel on
// the widened inputs: it is within one bf16 step of the plain version and
// at most one bf16 step from this kernel's rounded output, and every tile
// and the armed variant give its default tile's bits.  A bf16 model under
// conv_bfp reads bf16 x and bias with an f32 slab (ConvArgs.sdt = kF32:
// the reference dequantizes a BFP slab to f32 whatever it packed): its own
// instantiation of this FFMA kernel loads x with plain 2-byte loads and
// the slab with plain 4-byte loads, widened into the f32 rings, so it is
// bit-equal to the f32 kernel on the widened x and bias, rounded.  The
// dispatch is fixed by the dtype pair; neither route falls back to the
// other.
// Numerics (the FFMA route): each output is one thread's fmaf chain from
// +0 over (di, dj, c) in ascending order; zero-filled taps (padding, the
// ragged reduction tail) are FMA'd, not skipped, so a NaN weight poisons
// as in the plain version.  No TF32, no atomics, no split-K: the result
// is deterministic and does not depend on the tiling or the slab's
// blocking, so the block tile is a knob that cannot change the bits.  The
// LRN takes the same values and calls the same lrn_at in either stage.
// Files: the FFMA conv stage's kernel template and launcher are in
// conv_direct.cuh; this file instantiates the f32 ones and the epilogue,
// conv_direct_bf16.cu the bf16 ones (the tensor-core route and bf16 x on
// an f32 slab), so that nvcc builds the two sets side by side.
#include "conv_direct.cuh"

namespace conv_direct_impl {

// Grid (pooled tiles of PT x PT, B): LRN + max-pool from y in global memory.
__global__ void __launch_bounds__(kThreads)
conv_direct_epilogue(ConvArgs a, const float* __restrict__ y,
                     void* __restrict__ out) {
  fused_epilogue(a, y, out);
}

// The f32 conv stage.  ANY_SLAB: built for 4-byte slab copies too (the
// default tiles); the other tiles take 16-byte ones only and refuse a
// slab without them.  A bf16 launch has its own instantiations in
// conv_direct_bf16.cu.
template <int TM, int TN, bool ARMED, bool ANY_SLAB>
cudaError_t launch_tile(const ConvArgs& a, size_t smem, bool va, bool vb,
                        cudaStream_t stream, const GemmPtrs& p) {
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

}  // namespace conv_direct_impl

using namespace conv_direct_impl;

// x, bias and out in args->xdt's element type, the slab in args->sdt's
// (the same: f32 or bf16; or bf16 x with an f32 slab); y: (B, out_h,
// out_w, g*K) f32 scratch for the epilogue stage (unused, and may equal
// out, when there is no pool and no LRN left to apply); tm, tn: the conv
// stage's 16 tm x 16 tn block tile (the FFMA route's rows and columns per
// thread; its default tiles are 4 x 4 and 4 x 6; the bf16-slab
// tensor-core route's tiles are mma_built_for's).  Armed (args->verdict
// set, args->Cs = Cb + 1), the conv stage also adds the slab's mismatched
// checksum lanes to *args->verdict.
extern "C" int repro_conv_direct(const ConvArgs* args, const void* x,
                                 const void* slab, const void* bias,
                                 float* y, void* out, int tm, int tn,
                                 cudaStream_t stream) {
  const ConvArgs a = *args;
  const int R = a.r * a.r * a.C;
  const bool armed = a.verdict != nullptr;
  const size_t slab_elems =
      (size_t)a.g * a.nkb * a.ncb * a.r * a.r * a.Cs * a.Kb;
  const bool bf16 = a.xdt == kBf16;
  // the route is fixed by the dtypes: a bf16 slab (bf16 x) runs on the
  // tensor cores, an f32 one on the FFMA kernel
  const bool mma = bf16 && a.sdt == kBf16;
  const size_t smem = mma ? mma_smem_bytes(16 * tm, 16 * tn, R, armed)
                          : gemm_smem_bytes(tm, tn, R, armed);
  const bool va = mma ? a.C % 8 == 0 && (uintptr_t)x % 16 == 0
                      : !bf16 && a.C % 4 == 0 && (uintptr_t)x % 16 == 0;
  // a bf16-x FFMA launch has every tile the f32 one has for its slab's Kb
  const bool vb = mma ? a.Kb % 8 == 0 && (uintptr_t)slab % 16 == 0
                      : a.Kb % 4 == 0 && (bf16 || (uintptr_t)slab % 16 == 0);
  if ((a.xdt != kF32 && a.xdt != kBf16)
      || (a.sdt != a.xdt && !(a.xdt == kBf16 && a.sdt == kF32))
      || !(mma ? mma_built_for(16 * tm, 16 * tn) : built_for(tm, tn, vb))
      || a.r > 127 || a.C > 0xffff || slab_elems >= (1u << 31)
      || smem > 227 * 1024 || a.PT < 1
      || a.Cs != a.Cb + (armed ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  // the epilogue stage: the pool, and the LRN where the conv stage cannot
  // apply it (it then pools the LRN'd map)
  ConvArgs ea = a;
  if (lrn_in_gemm(a, 16 * tn)) ea.lrn_n = 0;
  const bool epilogue = ea.lrn_n || a.pwin != 1 || a.ps != 1;
  const GemmPtrs p{x, slab, bias, epilogue ? (void*)y : out,
                   bf16 && !epilogue};
  const cudaError_t err =
      mma    ? launch_conv_stage_mma(16 * tm, 16 * tn, a, smem, va, vb,
                                     stream, p)
      : bf16 ? launch_conv_stage_bf16(tm, tn, a, smem, stream, p)
             : launch_conv_stage(tm, tn, a, smem, va, vb, stream, p);
  if (err != cudaSuccess || !epilogue) return (int)err;
  const int nph = (a.ph_out + a.PT - 1) / a.PT;
  const int npw = (a.pw_out + a.PT - 1) / a.PT;
  conv_direct_epilogue<<<dim3(nph * npw, a.B), kThreads, 0, stream>>>(
      ea, y, out);
  return (int)cudaGetLastError();
}
