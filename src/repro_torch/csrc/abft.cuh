// ABFT slab check shared by the armed conv kernels (conv_direct.cu's conv
// stage, conv_winograd.cu's GEMM stage).
//
// Replaces the TPU kernels' verify_tile_checksum
// (src/repro/kernels/conv/dma.py), which checked each weight tile after
// its DMA into VMEM, once per (batch, row) grid block.  Here the check
// reads the whole packed slab that the launch reads, each lane once a
// launch: a lane is one (tile, spatial position, column) of the armed
// slab (n_tiles, S, Cb + 1, Kb), S = r * r or 36; it mismatches when the
// wraparound sum of its Cb rows' bit patterns, modulo 2**32 for a 4-byte
// slab and 2**16 for a bf16 one (the reference's int32 wraparound sum
// truncated to int16), differs from its checksum row
// (kernels/conv/dma.py: append_checksum_row).  The GEMMs
// never read padding rows or checksum rows, so this reads every row.
//
// Cost: one more read of the slab, spread over every block of the
// existing launch (no launch of its own: the served forwards are bound
// by the host's enqueue).  A block takes lane groups of 32 consecutive
// lanes, groups b, b + nblocks, ...; its 8 warps each sum every 8th row
// of the group (a warp's loads of one row are 32 neighbouring words), the
// partial sums meet in shared memory, and warp 0 compares and counts.
// (The bf16 tensor-core conv stage of conv_direct_bf16.cu calls it from
// blocks of 4 or 8 warps, kWarps.)
// It runs as the block's prologue while its cp.async ring fills.  The
// block adds its count to the verdict with one integer atomicAdd, or none
// when it is 0, so the verdict is deterministic.
#pragma once

#include <stdint.h>

#include "conv_args.cuh"

constexpr int kAbftWarps = 8;                 // a 256-thread block
constexpr int kAbftSmemInts = kAbftWarps * 32;

// Count this block's share of mismatched lanes of the armed slab (S
// spatial positions a tile; Word: the unsigned integer of the slab's
// element width) and add it to *a.verdict.  Every thread of the block of
// kWarps warps calls it; red: 32 kWarps ints of shared memory no other
// thread touches meanwhile.
template <typename Word, int kWarps = kAbftWarps>
__device__ __forceinline__ void abft_check_slab(const ConvArgs& a, int S,
                                                const void* slab,
                                                unsigned* red) {
  const Word* words = static_cast<const Word*>(slab);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lanes = (long long)a.g * a.nkb * a.ncb * S * a.Kb;
  const long long groups = (lanes + 31) / 32;
  const long long nblocks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long b = blockIdx.x + (long long)gridDim.x
                      * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  int count = 0;
  for (long long grp = b; grp < groups; grp += nblocks) {
    const long long l = grp * 32 + lane;
    const bool valid = l < lanes;
    // lane l = (tile * S + pos) * Kb + col: its rows at base + j * Kb
    const size_t base =
        valid ? (size_t)(l / a.Kb) * a.Cs * a.Kb + l % a.Kb : 0;
    unsigned s = 0;
    if (valid) {
#pragma unroll 4
      for (int j = warp; j < a.Cb; j += kWarps)
        s += __ldg(words + base + (size_t)j * a.Kb);
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (warp == 0) {
      unsigned total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += red[w * 32 + lane];
      const bool bad =
          valid && (Word)total != __ldg(words + base + (size_t)a.Cb * a.Kb);
      count += __popc(__ballot_sync(0xffffffffu, bad));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && count) atomicAdd(a.verdict, count);
}
