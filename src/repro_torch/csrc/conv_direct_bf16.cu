// bf16 instantiations of the direct conv layer's conv stage
// (conv_direct.cu, conv_direct.cuh): bf16 x and bias with a bf16 slab (the
// reference's bf16 model) or an f32 one (its conv_bfp slab), plain 2-byte
// and 4-byte loads widened into the f32 rings, armed and unarmed, at every
// block tile of the launcher.  A translation unit of its own, so that nvcc
// builds it beside the f32 instantiations.
#include "conv_direct.cuh"

namespace conv_direct_impl {

namespace {

template <int TM, int TN, bool ARMED>
cudaError_t launch_bf16_tile(const ConvArgs& a, size_t smem,
                             cudaStream_t stream, const GemmPtrs& p) {
  if (a.sdt == kBf16)
    return launch_gemm<TM, TN, false, false, ARMED, __nv_bfloat16>(
        a, smem, stream, p);
  return launch_gemm<TM, TN, false, false, ARMED, __nv_bfloat16, float>(
      a, smem, stream, p);
}

template <int TM, int TN>
cudaError_t launch_bf16_armed(const ConvArgs& a, size_t smem,
                              cudaStream_t stream, const GemmPtrs& p) {
  return a.verdict ? launch_bf16_tile<TM, TN, true>(a, smem, stream, p)
                   : launch_bf16_tile<TM, TN, false>(a, smem, stream, p);
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

}  // namespace conv_direct_impl
