"""Oracles for the BFP matmul kernel (the reference's
``repro/kernels/bfp_matmul/ref.py``): the plain quantize -> integer dot ->
rescale emulation, and the exact f32 product for error-bound checks."""
from __future__ import annotations

from ...core.bfp import bfp_matmul as bfp_matmul_ref  # noqa: F401
from ..conv.ref import _no_tf32


def exact_matmul(x, w):
    """Full-f32 ``x @ w`` (TF32 off on the card)."""
    with _no_tf32():
        return x.float() @ w.float()
