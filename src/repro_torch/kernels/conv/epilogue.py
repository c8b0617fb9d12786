"""Host-side block helpers shared by the conv kernels' plans.

The in-kernel half of the reference's ``epilogue.py`` (banded LRN, strided
max-pool) is ``csrc/epilogue.cuh``, shared by the direct and the fused
Winograd kernel; its plain PyTorch form is ``repro_torch.nn.pooling``.
"""
from __future__ import annotations

import torch

from ...core.winograd import auto_c_block


def channel_blocks(C: int, c_block: int | None, hp: int, wp: int,
                   batch: int = 1, *, dtype_bytes: int = 4) -> int:
    """Channel block size: explicit, or the reference's auto size."""
    if c_block is None:
        return auto_c_block(hp, wp, C, batch=batch, dtype_bytes=dtype_bytes)
    return min(c_block, C)


def k_blocks(K: int, k_block: int) -> int:
    """Output-channel block.  Blocks tile K exactly: zero-pad channels
    inside an LRN window would shadow the real cross-seam neighbours, so a
    non-dividing ``k_block`` widens to K."""
    Kb = min(k_block, K)
    return K if K % Kb else Kb


def batch_blocks(B: int, batch_block: int) -> tuple[int, int]:
    """(Bb, Bp): the reference's filter-cache depth and padded batch."""
    Bb = max(1, min(batch_block, B))
    return Bb, -(-B // Bb) * Bb


def grouped_channel_pad(x, g: int, Cb: int):
    """(B,H,W,g*C) -> (B,H,W,g*Cp) with each group's channels zero-padded to
    a ``Cb`` multiple (group-major layout)."""
    B, H, W, Ct = x.shape
    C = Ct // g
    padc = (-C) % Cb
    if not padc:
        return x, C
    x5 = torch.nn.functional.pad(x.reshape(B, H, W, g, C), (0, padc))
    return x5.reshape(B, H, W, g * (C + padc)), C
