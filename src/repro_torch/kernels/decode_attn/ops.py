"""Public entry for batched decode attention (the reference's
``repro/kernels/decode_attn/ops.py``): kernel 5 on a CUDA tensor, its plain
version on a CPU tensor.  ``pallas=False`` asks for the plain version on
any device, as the reference's flag asks for its oracle."""
from __future__ import annotations

import torch

from . import decode_attn as _k
from .ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, lengths, *, pallas: bool = True,
                     return_lse: bool = False):
    """``return_lse``: also the f32 log-sum-exp (B, H), an empty slot
    giving output 0 and lse -inf (``ref.decode_attention_ref``)."""
    lengths = torch.as_tensor(lengths, device=q.device)
    if lengths.ndim == 0:
        lengths = lengths.expand(q.shape[0])
    if pallas:
        return _k.decode_attention(q, k_cache, v_cache, lengths,
                                   return_lse=return_lse)
    return decode_attention_ref(q, k_cache, v_cache, lengths,
                                return_lse=return_lse)


def launch_counts() -> dict:
    """CUDA-kernel launches so far (the plain version does not count)."""
    return {"decode_attn": _k.launches}


def reset_launch_counts():
    _k.launches = 0
