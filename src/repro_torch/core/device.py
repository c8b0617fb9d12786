"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``: the port exists to run on the
card, so a missing card is an error, never a silent CPU fallback.  Tests
pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
