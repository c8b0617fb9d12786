"""Kernel 5, batched single-token GQA decode attention: the port of the
reference's ``_decode_kernel`` (``repro/kernels/decode_attn/
decode_attn.py:26``), the serving engine's hot spot.

:func:`decode_attention` pre-scales q by D**-0.5 in q's dtype (part of the
function, as in the reference; the kernel does it with the factor of
``ref.prescale_factor``) and runs ``csrc/decode_attn.cu`` on a CUDA tensor;
on a CPU tensor it runs the plain version, ``ref.py``.  A failed
launch raises :class:`build.KernelError`; nothing falls back.

The kernel splits each slot's cache rows over blocks (flash decoding);
the last block of a slot to finish merges the splits' partial states,
found by an integer ticket.  Its launch geometry is here, as pure
functions of the shape (never of the lengths, which stay on the card):
:func:`split_rows`, :func:`decode_grid`, :func:`scratch_shape` and
:func:`split_bounds`, the rows each split reads.
"""
from __future__ import annotations

import functools
import math

import torch

from ...core import opcount
from .. import build
from .ref import decode_attention_ref, prescale, prescale_factor  # noqa: F401

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# head dims and dtypes the kernel is built for (one 16-byte load per lane
# covers 8 bf16 or 4 f32 values of a cache row; 96 is phi-3-vision's)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's blocking (csrc/decode_attn.cu): query heads a block (one warp
# each) and cache rows a tile (one lane each)
HEADS_PER_BLOCK = 4
TILE_ROWS = 32
# a split covers at most MAX_SPLIT_ROWS rows; fewer where the grid would
# otherwise launch under MIN_BLOCKS blocks (132 SMs on the H100); more where
# a slot would have over MAX_SPLITS splits (the merge's limit)
MAX_SPLIT_ROWS = 256
MIN_BLOCKS = 264
MAX_SPLITS = 128


@functools.lru_cache(maxsize=None)
def split_rows(B: int, S: int, KV: int, G: int, D: int) -> int:
    """Cache rows a split, R: the largest power of two from
    ``MAX_SPLIT_ROWS`` down to ``TILE_ROWS`` whose grid still has
    ``MIN_BLOCKS`` blocks (or ``TILE_ROWS`` if none has), doubled while S
    needs over ``MAX_SPLITS`` splits.  A function of the shape only, so the
    host never reads the lengths."""
    per_split = B * KV * math.ceil(G / HEADS_PER_BLOCK)
    R = MAX_SPLIT_ROWS
    while R > TILE_ROWS and per_split * math.ceil(S / R) < MIN_BLOCKS:
        R //= 2
    while math.ceil(S / R) > MAX_SPLITS:
        R *= 2
    return R


def decode_grid(B: int, S: int, KV: int, G: int, D: int) -> tuple:
    """The launch's grid: (splits, KV heads x chunks of
    ``HEADS_PER_BLOCK`` query heads, slots)."""
    R = split_rows(B, S, KV, G, D)
    return (math.ceil(S / R), KV * math.ceil(G / HEADS_PER_BLOCK), B)


def scratch_shape(B: int, S: int, KV: int, G: int, D: int) -> tuple:
    """The f32 partial states the splits write and their merge reads:
    (B, KV, splits, G, D + 2), acc[D] then the running max and sum."""
    return (B, KV, decode_grid(B, S, KV, G, D)[0], G, D + 2)


_TICKETS: dict = {}


def _tickets(device, stream: int, n: int):
    """The kernel's merge tickets: int32, zero between calls (the block that
    merges a slot's splits sets its ticket back to 0), one buffer per
    device and stream, grown as needed."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def decode_work(B: int, H: int, KV: int, D: int, valid_rows: int,
                itemsize: int) -> tuple:
    """(operations, bytes) of one decode attention, 2 operations a
    multiply-add: q.k and p.v for each of ``valid_rows`` cache rows (summed
    over the slots) and query head (4 D); bytes: those rows of k and v
    read once, q read and the output written in the caches' dtype
    (``itemsize``), the int32 lengths."""
    flops = 4 * valid_rows * H * D
    nbytes = (2 * valid_rows * KV * D * itemsize + 2 * B * H * D * itemsize
              + 4 * B)
    return flops, nbytes


def split_bounds(length: int, S: int, R: int) -> list:
    """The [lo, hi) cache rows of each split that reads any, as the kernel
    bounds them: n = S for length <= 0 (uniform attention), else
    min(length, S); split i reads [i R, min((i + 1) R, n)); the slot's
    merge takes the first ceil(n / R) splits."""
    n = S if length <= 0 else min(length, S)
    return [(lo, min(lo + R, n)) for lo in range(0, n, R)]


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


def _decode_attention_cuda(q, k_cache, v_cache, lengths, return_lse):
    global launches
    B, _, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    if q.dtype not in _DTYPE_CODE or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention: the kernel takes "
                         f"{list(_DTYPE_CODE)} at D in {KERNEL_HEAD_DIMS}; "
                         f"got {q.dtype}, D={D}")
    q = q.contiguous()
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
    G = H // KV
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    part = torch.empty(scratch_shape(B, S, KV, G, D), dtype=torch.float32,
                       device=q.device)
    if q.device.type == "meta":
        # the lengths are not known on meta: every cache row counts
        opcount.record_kernel("decode_attn", *decode_work(
            B, H, KV, D, B * S, q.element_size()))
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream,
                       B * KV * math.ceil(G / HEADS_PER_BLOCK))
    err = build.library().lib.repro_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        prescale_factor(q), B, S, H, KV, D,
        split_rows(B, S, KV, G, D), _DTYPE_CODE[q.dtype], stream)
    build.check(err, "decode_attn")
    launches += 1
    return (out, lse) if return_lse else out


def decode_attention(q, k_cache, v_cache, lengths, return_lse: bool = False):
    """q (B, 1, H, D); caches (B, S, KV, D) in q's dtype; lengths (B,)
    int -> (B, 1, H, D) in q's dtype.  ``return_lse``: also each (slot,
    head)'s f32 log-sum-exp of its scaled scores (B, H), and a slot of
    length <= 0 gives output 0 and lse -inf where without it the
    attention is uniform over every row (one rank's block of a cache split
    over ``model`` may hold no valid row).  On meta tensors (the dry run) the
    CUDA path's outputs and scratch, and its launch recorded with
    :func:`decode_work` over every cache row: the lengths are not known
    there (the dry run's decode step fills the cache to all but its last
    row, so the count is exact to within one row a slot)."""
    _check_args(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_attention_cuda(q, k_cache, v_cache, lengths, return_lse)
