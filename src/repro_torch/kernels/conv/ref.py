"""``F.conv2d`` oracle with the fused-layer signature: the port's ``direct``
route and the reference every kernel is held against."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    """Full-f32 convolutions and matmuls for the duration of one call (a
    float32 conv otherwise runs through cuDNN in TF32 by default)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def same_pad(extent: int, r: int, stride: int) -> tuple[int, int, int]:
    """(out, pad_lo, pad_hi) for SAME padding, matching lax.conv semantics."""
    out = -(-extent // stride)
    total = max((out - 1) * stride + r - extent, 0)
    return out, total // 2, total - total // 2


def conv2d_ref(x, w, b=None, *, stride: int = 1, padding: str = "SAME",
               groups: int = 1, relu: bool = False, lrn=None, pool=None):
    """x (B,H,W,C) NHWC, w (r,r,C//groups,K) HWIO; optional bias (K,), fused
    ReLU, groups, then LRN and VALID max-pool.  SAME pads as lax does
    (the extra row/col, if any, goes at the high end)."""
    r = w.shape[0]
    xc = x.float().permute(0, 3, 1, 2)
    if padding == "SAME":
        _, h_lo, h_hi = same_pad(x.shape[1], r, stride)
        _, w_lo, w_hi = same_pad(x.shape[2], r, stride)
        xc = F.pad(xc, (w_lo, w_hi, h_lo, h_hi))
    with _no_tf32():
        y = F.conv2d(xc, w.float().permute(3, 2, 0, 1), stride=stride,
                     groups=groups)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    if lrn is not None or pool is not None:
        from ...nn.pooling import apply_epilogue
        y = apply_epilogue(y, lrn, pool)
    return y.to(x.dtype).contiguous()
