"""Public entry for the shared-exponent BFP matmul (the reference's
``repro/kernels/bfp_matmul/ops.py``), int8 mantissas: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor.  The plain oracle of the
reference's ``pallas=False`` is ``core.bfp.bfp_matmul``.
"""
from __future__ import annotations

import math

import torch

from . import bfp_matmul as _k


def fc_block(k: int, block: int = 32) -> int:
    """The exponent-block size ``bfp_linear`` resolves for contraction dim
    ``k``: it must tile ``k`` exactly, so a non-dividing block shrinks to
    the gcd (reduced configs have small FC widths; 32 is the paper's)."""
    return math.gcd(k, block)


def quantize_weights(w, *, block: int = 32):
    """Pre-quantize an FC weight stream: (K, N) f32 -> (mantissas in the
    kernel's layout, per-block exponents).  A pure function of the
    weights, so a model stages it once and passes the pair to
    :func:`bfp_matmul` / :func:`bfp_linear` as ``quantized``."""
    return _k.quantize_weights(w.to(torch.float32), block=block)


def bfp_matmul(x, w, *, block: int = 32, quantized=None):
    """(M, K) @ (K, N) in shared-exponent block floating point.  The
    kernel has no backward, as the reference's has none: with grad mode
    on, an ``x`` or ``w`` that requires grad raises, rather than return an
    output that silently carries no gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError("bfp_matmul: the BFP matmul kernel (fc_bfp) has no "
                         "backward; differentiate with fc_bfp=False")
    wq, we = (quantized if quantized is not None
              else _k.quantize_weights(w, block=block))
    return _k.bfp_matmul(x, wq, we, block=block)


def bfp_linear(x, w, *, block: int = 32, quantized=None):
    """(..., K) @ (K, N) -> f32, with the weight stream in int8 BFP (§3.6).

    x and w are taken as f32, as the reference casts them: a bf16 x goes
    to the kernel as it is (its pre-pass widens it exactly, with no cast
    launch), a bf16 w is widened before it is quantized.  The exponent
    block resolves via :func:`fc_block`.  ``quantized`` is a staged
    ``quantize_weights(w, block=fc_block(K, block))`` pair; the
    quantization is then skipped."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if x2.dtype not in _k.X_DTYPES:
        x2 = x2.to(torch.float32)
    y = bfp_matmul(x2, w if quantized is not None else w.to(torch.float32),
                   block=fc_block(k, block), quantized=quantized)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def launch_counts() -> dict:
    """CUDA-kernel launches so far (the plain version does not count)."""
    return {"bfp_matmul": _k.launches}


def reset_launch_counts():
    _k.launches = 0
