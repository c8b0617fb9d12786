"""Kernel 5, batched single-token GQA decode attention: the port of the
reference's ``_decode_kernel`` (``repro/kernels/decode_attn/
decode_attn.py:26``), the serving engine's hot spot.

:func:`decode_attention` pre-scales q by D**-0.5 in q's dtype (part of the
function, as in the reference) and runs ``csrc/decode_attn.cu`` on a CUDA
tensor; on a CPU tensor it runs the plain version, ``ref.py``.  A failed
launch raises :class:`build.KernelError`; nothing falls back.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import decode_attention_ref, prescale

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# head dims and dtypes the kernel is built for (one 16-byte load per lane
# covers 8 bf16 or 4 f32 values of a cache row)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k_cache, v_cache, lengths):
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} is not "
                         f"(B, 1, H, D) or k {tuple(k_cache.shape)} not "
                         "(B, S, KV, D)")
    B, _, H, D = q.shape
    Bk, _, KV, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape or (Bk, Dk) != (B, D) \
            or KV == 0 or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}"
                         " do not fit (H % KV == 0)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)}"
                         f" is not ({B},)")


def _decode_attention_cuda(q, k_cache, v_cache, lengths):
    global launches
    B, _, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    if q.dtype not in _DTYPE_CODE or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention: the kernel takes "
                         f"{list(_DTYPE_CODE)} at D in {KERNEL_HEAD_DIMS}; "
                         f"got {q.dtype}, D={D}")
    qs = prescale(q).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    for t in (k_cache, v_cache):
        if t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention: caches must be contiguous, "
                             f"16-byte aligned {q.dtype} on {q.device}; got "
                             f"{t.dtype} on {t.device}, contiguous="
                             f"{t.is_contiguous()}")
    if lengths.device != q.device:
        raise ValueError(f"decode_attention: lengths on {lengths.device}, "
                         f"q on {q.device}")
    out = torch.empty_like(qs)
    err = build.library().lib.repro_decode_attn(
        qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, S, H, KV, D,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attn")
    launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, 1, H, D); caches (B, S, KV, D) in q's dtype; lengths (B,)
    int -> (B, 1, H, D) in q's dtype."""
    _check_args(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_attention_cuda(q, k_cache, v_cache, lengths)
