"""Post-conv layer epilogues: cross-channel LRN + spatial max-pool (NHWC).

The single numerical definition every conv route and the kernels' plain
versions compare against; the CUDA kernels carry the same math in
``csrc/epilogue.cuh``.  Mirrors ``repro/nn/pooling.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LrnParams:
    """Krizhevsky cross-channel local response normalization constants.

    y[c] = x[c] / (k + alpha/n * sum_{|d| <= n//2} x[c+d]^2)^beta
    """
    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def __post_init__(self):
        assert self.n >= 1 and self.n % 2 == 1, self.n


def lrn(x, p: LrnParams = LrnParams()):
    """Cross-channel LRN on NHWC; the window runs over channels only, with
    zeros past the channel boundaries."""
    half = p.n // 2
    K = x.shape[-1]
    sq = torch.nn.functional.pad(x * x, (half, half))
    win = sq[..., 0:K]
    for d in range(1, p.n):
        win = win + sq[..., d:d + K]
    return x / torch.pow(p.k + p.alpha / p.n * win, p.beta)


def maxpool2d(x, window: int = 3, stride: int = 2):
    """VALID spatial max-pool on NHWC via window**2 strided slices."""
    ph = pooled_hw(x.shape[1], window, stride)
    pw = pooled_hw(x.shape[2], window, stride)
    y = None
    for di in range(window):
        for dj in range(window):
            sl = x[:, di:di + stride * (ph - 1) + 1:stride,
                   dj:dj + stride * (pw - 1) + 1:stride]
            y = sl if y is None else torch.maximum(y, sl)
    return y


def pooled_hw(h: int, window: int = 3, stride: int = 2) -> int:
    """Output extent of a VALID ``window``/``stride`` pool over ``h``."""
    return (h - window) // stride + 1


def apply_epilogue(y, lrn_params=None, pool=None):
    """LRN (LrnParams or None) then max-pool ((window, stride) or None)."""
    if lrn_params is not None:
        y = lrn(y, lrn_params)
    if pool is not None:
        y = maxpool2d(y, *pool)
    return y
