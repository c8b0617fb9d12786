"""Direct-convolution oracles: ``F.conv2d`` with the fused-layer signature
(the port's ``direct`` route and the reference every 2-D kernel is held
against) and the shift-multiply depthwise causal 1-D conv."""
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


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` in full f32 in the backward too: autograd runs a conv's
    backward after the forward's context has closed, where cuDNN allows
    TF32 by default."""

    @staticmethod
    def forward(ctx, x, w, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


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
    y = _Conv2dF32.apply(xc, w.float().permute(3, 2, 0, 1), stride, groups)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    from ...nn.pooling import apply_epilogue, relu as relu_
    if relu:
        y = relu_(y)
    if lrn is not None or pool is not None:
        y = apply_epilogue(y, lrn, pool)
    return y.to(x.dtype).contiguous()


def conv1d_depthwise_causal_ref(x, w, b=None):
    """Direct (shift-multiply) causal depthwise conv in x's dtype; x (B,L,C),
    w (r,C)."""
    r = w.shape[0]
    xp = F.pad(x, (0, 0, r - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(r))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
