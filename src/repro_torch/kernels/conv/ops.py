"""Public entry points for the conv kernel family (the reference's
``repro/kernels/conv/ops.py``).

* :func:`conv1d_depthwise_causal` — kernel 7, Mamba-2's depthwise causal
  conv, with its backward as a ``torch.autograd.Function`` (the
  reference's custom VJP): dx is kernel 7 run time-reversed on the
  cotangent, dw and db a deterministic reduction kernel; ``pallas=False``
  runs the pure-torch Winograd twin, which autograd differentiates.
* :func:`conv2d` — the Winograd kernels for stride-1 layers;
  ``pallas=False`` runs the pure-torch Winograd route.
* :func:`conv2d_direct` — the strided direct kernel for any geometry;
  ``pallas=False`` runs the ``F.conv2d`` oracle.

``pallas`` keeps the reference's name: it selects the hand-written-kernel
datapath (CUDA here).  ``checksum=True`` (ABFT) makes both 2-D entries
return ``(y, verdict)`` on every route: the kernels' count of mismatched
checksum lanes, and a zero verdict on the routes without a slab.
"""
from __future__ import annotations

import torch

from ...core import winograd as wg
from . import direct as _d
from . import winograd as _k
from .direct import new_verdict
from .ref import conv2d_ref


class _Dw1d(torch.autograd.Function):
    """Kernel 7 with the reference's VJP (``_dw1d_bwd``): dx = kernel 7
    on the time-reversed cotangent, cast to x's dtype; dw summed in f32
    and db summed in dy's dtype, both cast to w's dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _k.conv1d_depthwise_causal(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _k.conv1d_depthwise_causal_dx(dy, w).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _k.conv1d_depthwise_causal_wgrad(x.contiguous(), dy,
                                                      w.shape[0])
            dw, db = dw.to(w.dtype), db.to(w.dtype)
        return dx, dw, db if ctx.has_bias else None


def conv1d_depthwise_causal(x, w, b=None, *, pallas: bool = True):
    """x (B,L,C); w (r,C); b (C,) or None -> (B,L,C), left-padded causal.

    ``pallas=True`` runs kernel 7 (its plain version on a CPU tensor), f32
    inside, and its backward kernels when autograd asks for gradients;
    ``pallas=False`` the pure-torch Winograd in x's dtype, which autograd
    differentiates."""
    if pallas:
        return _Dw1d.apply(x, w, b)
    return wg.conv1d_depthwise_causal(x, w, b)


def conv2d(x, w, b=None, w_packed=None, *, m: int = 4, padding: str = "SAME",
           relu: bool = False, groups: int = 1, lrn=None, pool=None,
           c_block: int | None = None, pool_row_block: int | None = None,
           k_block: int = 128, batch_block: int = 8,
           weight_prefetch: bool = True, checksum: bool = False,
           verdict=None, tile_rows: int | None = None,
           tile_cols: int | None = None, pallas: bool = True):
    """Fused stride-1 Winograd conv layer: bias, ReLU, groups, LRN, pool;
    ``tile_rows``/``tile_cols`` pick the kernel's GEMM block tile."""
    if pallas:
        return _k.conv2d_winograd(x, w, b, w_packed, m=m, padding=padding,
                                  relu=relu, groups=groups, lrn=lrn,
                                  pool=pool, c_block=c_block,
                                  pool_row_block=pool_row_block,
                                  k_block=k_block, batch_block=batch_block,
                                  weight_prefetch=weight_prefetch,
                                  checksum=checksum, verdict=verdict,
                                  tile_rows=tile_rows, tile_cols=tile_cols)
    y = wg.conv2d_winograd(x, w, b, m=m, padding=padding, relu=relu,
                           groups=groups, lrn=lrn, pool=pool)
    return (y, new_verdict(x, verdict)) if checksum else y


def conv2d_direct(x, w, b=None, w_packed=None, *, stride: int = 1,
                  padding: str = "SAME", relu: bool = False, groups: int = 1,
                  lrn=None, pool=None, c_block: int | None = None,
                  pool_row_block: int | None = None, k_block: int = 128,
                  batch_block: int = 8, weight_prefetch: bool = True,
                  checksum: bool = False, verdict=None,
                  tile_rows: int | None = None,
                  tile_cols: int | None = None, pallas: bool = True):
    """Fused direct conv layer for any kernel/stride geometry;
    ``tile_rows``/``tile_cols`` pick the kernel's conv-stage block tile."""
    if pallas:
        return _d.conv2d_direct(x, w, b, w_packed, stride=stride,
                                padding=padding, relu=relu, groups=groups,
                                lrn=lrn, pool=pool, c_block=c_block,
                                pool_row_block=pool_row_block,
                                k_block=k_block, batch_block=batch_block,
                                weight_prefetch=weight_prefetch,
                                checksum=checksum, verdict=verdict,
                                tile_rows=tile_rows, tile_cols=tile_cols)
    y = conv2d_ref(x, w, b, stride=stride, padding=padding, groups=groups,
                   relu=relu, lrn=lrn, pool=pool)
    return (y, new_verdict(x, verdict)) if checksum else y


def launch_counts() -> dict:
    """CUDA-kernel launches so far, by kernel."""
    return {"conv_direct": _d.launches, "conv_winograd": _k.launches,
            "conv_winograd_fused": _k.fused_launches,
            "dw1d": _k.dw1d_launches, "dw1d_bwd": _k.dw1d_bwd_launches,
            "dw1d_wgrad": _k.dw1d_wgrad_launches}


def reset_launch_counts():
    _d.launches = 0
    _k.launches = 0
    _k.fused_launches = 0
    _k.dw1d_launches = 0
    _k.dw1d_bwd_launches = 0
    _k.dw1d_wgrad_launches = 0
