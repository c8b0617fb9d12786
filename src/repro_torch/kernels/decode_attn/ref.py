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


def _attend(q, k_cache, v_cache, lengths, p_dtype, with_lse=False):
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
    o = o.reshape(B, 1, H, D).to(q.dtype)
    if not with_lse:
        return o
    # a block with no valid row: output 0, lse -inf (its merge weight 0)
    empty = (lengths.expand(B) <= 0)
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    lse = torch.where(empty[:, None], -torch.inf, lse)
    o = torch.where(empty[:, None, None, None], 0.0, o).to(q.dtype)
    return o, lse


def decode_attention_ref(q, k_cache, v_cache, lengths,
                         return_lse: bool = False):
    """q (B, 1, H, D) against caches (B, S, KV, D); positions >= lengths
    (a (B,) tensor or a scalar) are masked -> (B, 1, H, D) in q's dtype.

    q is pre-scaled by D**-0.5 in its own dtype, scores and softmax are
    f32, and the probabilities are cast to v's dtype before the PV
    product, which accumulates in f32 — all as in the reference.  KV heads
    are never repeated: the G = H / KV query heads of one KV head form a
    group.  With length 0 every score is masked alike, so the softmax is
    uniform: the output is the mean of v over all S positions.

    ``return_lse`` (the mode for one block of a cache split over ranks)
    also returns the f32 log-sum-exp of each (slot, head)'s scaled scores
    (B, H), and a slot of length <= 0 gives output 0 and lse -inf."""
    return _attend(q, k_cache, v_cache, lengths, v_cache.dtype, return_lse)


def decode_attention_f32_ref(q, k_cache, v_cache, lengths,
                             return_lse: bool = False):
    """:func:`decode_attention_ref` with the probabilities kept in f32, as
    the reference's TPU kernel and the CUDA kernel keep them: after the
    pre-scale of q, the only rounding is the output's to q's dtype.  The
    same function as :func:`decode_attention_ref` in f32; in bf16 the
    kernel is held against this one, within about one bf16 step."""
    return _attend(q, k_cache, v_cache, lengths, torch.float32, return_lse)


def merge_blocks(outs, lses):
    """The attention over a whole cache from its blocks' ``return_lse``
    results: ``outs`` (R, B, 1, H, D) and ``lses`` (R, B, H) f32, block r
    holding rows [r L / R, (r + 1) L / R) -> (o (B, 1, H, D) in outs'
    dtype, lse (B, H)).  Each block's output is weighted by exp(lse_r -
    max lse) over the weights' sum, in f32 and in block order; an empty
    block weighs 0, and where every block is empty the output is 0."""
    M = lses.amax(dim=0)
    finite = torch.isfinite(M)
    M0 = torch.where(finite, M, 0.0)
    acc = den = None
    for o, lse in zip(outs.unbind(0), lses.unbind(0)):
        w = torch.exp(lse - M0)
        term = o.to(torch.float32) * w[:, None, :, None]
        acc = term if acc is None else acc + term
        den = w if den is None else den + w
    o = torch.where(finite[:, None, :, None],
                    acc / den.clamp(min=1e-30)[:, None, :, None], 0.0)
    return o.to(outs.dtype), torch.where(finite, M0 + torch.log(den), M)
