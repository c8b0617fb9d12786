"""Plain version of kernel 5: the grouped einsum the reference's models
call (``repro/nn/flash.py::decode_attention``), which its kernel package
names as the decode kernel's oracle."""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


def prescale_factor(q) -> float:
    """D**-0.5 rounded to q's dtype, as the reference's weakly typed
    ``q * (D ** -0.5)`` rounds it: for D = 128 in bf16 this rounding is part
    of the function."""
    return _factor(q.shape[-1], q.dtype)


@functools.lru_cache(maxsize=None)
def _factor(D: int, dtype) -> float:
    return torch.tensor(D ** -0.5, dtype=dtype).item()


def prescale(q):
    """q * D**-0.5 in q's dtype (the product of f32 values, rounded once)."""
    return q * prescale_factor(q)


def _attend(q, k_cache, v_cache, lengths, p_dtype):
    B, _, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qg = prescale(q).reshape(B, KV, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    lengths = torch.as_tensor(lengths, device=q.device)
    valid_to = lengths if lengths.ndim == 0 else lengths[:, None, None, None]
    mask = torch.arange(S, device=q.device)[None, None, None, :] < valid_to
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(p_dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q (B, 1, H, D) against caches (B, S, KV, D); positions >= lengths
    (a (B,) tensor or a scalar) are masked -> (B, 1, H, D) in q's dtype.

    q is pre-scaled by D**-0.5 in its own dtype, scores and softmax are
    f32, and the probabilities are cast to v's dtype before the PV
    product, which accumulates in f32 — all as in the reference.  KV heads
    are never repeated: the G = H / KV query heads of one KV head form a
    group.  With length 0 every score is masked alike, so the softmax is
    uniform: the output is the mean of v over all S positions."""
    return _attend(q, k_cache, v_cache, lengths, v_cache.dtype)


def decode_attention_f32_ref(q, k_cache, v_cache, lengths):
    """:func:`decode_attention_ref` with the probabilities kept in f32, as
    the reference's TPU kernel and the CUDA kernel keep them: after the
    pre-scale of q, the only rounding is the output's to q's dtype.  The
    same function as :func:`decode_attention_ref` in f32; in bf16 the
    kernel is held against this one, within about one bf16 step."""
    return _attend(q, k_cache, v_cache, lengths, torch.float32)
