"""Public entry for the SSD scan (the reference's
``repro/kernels/ssd/ops.py``): kernel 6 on a CUDA tensor and its plain
version on a CPU tensor, or, with ``pallas=False``, the pure-torch chunked
twin the models' reference path uses (``nn.ssd.ssd_chunked``, which rounds
some intermediates to x's dtype, as the reference's does)."""
from __future__ import annotations

import torch

from . import ssd as _k


def ssd_chunked(x, dt, A, B_, C_, *, chunk: int = 256, pallas: bool = True):
    """``pallas=True`` runs kernel 6 (its plain version on a CPU tensor).
    The kernel has no backward, as the reference's has no VJP, so an input
    that requires grad raises instead of leaving the graph; training takes
    ``pallas=False``, the differentiable chunked twin, as the reference's
    model does."""
    if pallas:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, B_, C_)):
            raise NotImplementedError(
                "kernel 6 (ssd_chunked, pallas=True) has no backward (the "
                "reference's has no VJP; ROADMAP Queue 1, item 7d): "
                "training takes the differentiable twin, pallas=False "
                "(nn/ssd.py in mode 'train'); run the kernel under "
                "torch.no_grad()")
        return _k.ssd_chunked_pallas(x, dt, A, B_, C_, chunk=chunk)
    from ...nn.ssd import ssd_chunked as torch_impl
    return torch_impl(x, dt, A, B_, C_, chunk)


def launch_counts() -> dict:
    """CUDA-kernel launches so far (the plain version does not count)."""
    return {"ssd": _k.launches}


def reset_launch_counts():
    _k.launches = 0
