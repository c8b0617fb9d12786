// Geometry of one conv launch, shared by the three conv kernels and their
// C launchers.  Field order is mirrored by ConvArgs in
// repro_torch/kernels/build.py (ctypes): change both together.
#pragma once

struct ConvArgs {
  int B, H, W, Ct;          // input NHWC extent, Ct = g * C
  int g, C, K;              // groups, in / out channels per group
  int r, s, pad_h, pad_w;   // filter size, stride, low-side zero padding
  int out_h, out_w;         // conv output extent
  int ncb, Cb, nkb, Kb;     // packed-slab blocking (tile lin = k * ncb + c)
  int relu;                 // fused ReLU after the bias
  int lrn_n;                // LRN window (0: no LRN)
  float lrn_k, lrn_alpha, lrn_beta;
  int pwin, ps;             // VALID max-pool window / stride (1, 1: none)
  int ph_out, pw_out;       // epilogue output extent
  int PT;                   // epilogue outputs per thread-block side
};
