"""Public entry points for the 2-D conv kernel family (the reference's
``repro/kernels/conv/ops.py``; the depthwise 1-D op waits for its kernel,
ROADMAP Queue 1, item 7).

* :func:`conv2d` — the Winograd kernels for stride-1 layers;
  ``pallas=False`` runs the pure-torch Winograd route.
* :func:`conv2d_direct` — the strided direct kernel for any geometry;
  ``pallas=False`` runs the ``F.conv2d`` oracle.

``pallas`` keeps the reference's name: it selects the hand-written-kernel
datapath (CUDA here).
"""
from __future__ import annotations

from ...core import winograd as wg
from . import direct as _d
from . import winograd as _k
from .ref import conv2d_ref


def conv2d(x, w, b=None, w_packed=None, *, m: int = 4, padding: str = "SAME",
           relu: bool = False, groups: int = 1, lrn=None, pool=None,
           c_block: int | None = None, pool_row_block: int | None = None,
           k_block: int = 128, batch_block: int = 8,
           weight_prefetch: bool = True, checksum: bool = False,
           pallas: bool = True):
    """Fused stride-1 Winograd conv layer: bias, ReLU, groups, LRN, pool."""
    if pallas:
        return _k.conv2d_winograd(x, w, b, w_packed, m=m, padding=padding,
                                  relu=relu, groups=groups, lrn=lrn,
                                  pool=pool, c_block=c_block,
                                  pool_row_block=pool_row_block,
                                  k_block=k_block, batch_block=batch_block,
                                  weight_prefetch=weight_prefetch,
                                  checksum=checksum)
    if checksum:
        raise NotImplementedError("ABFT is not ported yet (ROADMAP Queue 1, "
                                  "item 1)")
    return wg.conv2d_winograd(x, w, b, m=m, padding=padding, relu=relu,
                              groups=groups, lrn=lrn, pool=pool)


def conv2d_direct(x, w, b=None, w_packed=None, *, stride: int = 1,
                  padding: str = "SAME", relu: bool = False, groups: int = 1,
                  lrn=None, pool=None, c_block: int | None = None,
                  pool_row_block: int | None = None, k_block: int = 128,
                  batch_block: int = 8, weight_prefetch: bool = True,
                  checksum: bool = False, pallas: bool = True):
    """Fused direct conv layer for any kernel/stride geometry."""
    if pallas:
        return _d.conv2d_direct(x, w, b, w_packed, stride=stride,
                                padding=padding, relu=relu, groups=groups,
                                lrn=lrn, pool=pool, c_block=c_block,
                                pool_row_block=pool_row_block,
                                k_block=k_block, batch_block=batch_block,
                                weight_prefetch=weight_prefetch,
                                checksum=checksum)
    if checksum:
        raise NotImplementedError("ABFT is not ported yet (ROADMAP Queue 1, "
                                  "item 1)")
    return conv2d_ref(x, w, b, stride=stride, padding=padding, groups=groups,
                      relu=relu, lrn=lrn, pool=pool)


def launch_counts() -> dict:
    """CUDA-kernel launches so far, by kernel."""
    return {"conv_direct": _d.launches, "conv_winograd": _k.launches,
            "conv_winograd_fused": _k.fused_launches}


def reset_launch_counts():
    _d.launches = 0
    _k.launches = 0
    _k.fused_launches = 0
