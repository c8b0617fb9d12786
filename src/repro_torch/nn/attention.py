"""GQA attention with RoPE (the reference's ``repro/nn/attention.py``).

Modes:
  train   — causal blockwise attention with the flash backward, no cache
            (``banded_attention`` picks the lower-triangle schedule; under
            ``remat_policy="save_attn"`` the layer's checkpoint keeps the
            flash output, ``flash.FLASH_OP``).
  prefill — causal, and the layer's K/V written into its cache.
  decode  — S new tokens (one, in serving) against the cache at per-slot
            offsets; the attention itself is kernel 5 on the card.

The cache is updated in place (the serving engine owns one preallocated
(B, max_len, KV, D) pair per layer, as the reference donates its cache to
the jitted step) and returned.  MLA and cross-attention come with ROADMAP
Queue 1, item 7c.
"""
from __future__ import annotations

import torch

from ..config import ArchConfig
from . import flash
from .layers import linear, linear_init, rope
from .module import torch_dtype


def _check_supported(cfg: ArchConfig, cross: bool = False):
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP "
                                  "Queue 1, item 7c)")
    if cross or cfg.cross_attention:
        raise NotImplementedError("cross-attention is not ported yet "
                                  "(ROADMAP Queue 1, item 7c)")


def attn_init(gen, cfg: ArchConfig, cross: bool = False):
    _check_supported(cfg, cross)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "wq": linear_init(gen, d, H * hd, dtype, bias=cfg.qkv_bias),
        "wk": linear_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias),
        "wv": linear_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias),
        "wo": linear_init(gen, H * hd, d, dtype, bias=cfg.qkv_bias),
    }


def attn_cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    """Cache structure of one attention layer: {name: (shape, dtype)}."""
    _check_supported(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.d_head)
    dt = torch_dtype(cfg.dtype)
    return {"k": (shape, dt), "v": (shape, dt)}


def gqa_apply(p, cfg: ArchConfig, x, *, mode: str, length=None, cache=None):
    """x (B, S, d_model) -> (y (B, S, d_model), cache)."""
    _check_supported(cfg)
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, KV, hd)
    v = linear(p["wv"], x).reshape(B, S, KV, hd)
    if mode in ("train", "prefill"):
        pos = torch.arange(S, device=x.device)[None, :]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o = flash.flash_attention(q, k, v, causal=True,
                                  banded=cfg.banded_attention)
        if mode == "prefill" and cache is not None:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    elif mode == "decode":
        posv = pos_of(length, S, x.device)
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
        cache_write(cache["k"], k, length)
        cache_write(cache["v"], v, length)
        o = flash.decode_attention(q, cache["k"], cache["v"], length + S)
    else:
        raise ValueError(mode)
    y = linear(p["wo"], o.reshape(B, S, H * hd))
    return y.to(x.dtype), cache


def cache_write(buf, val, length):
    """Write ``val`` (B, S, ...) into ``buf`` (B, L, ...) at sequence offset
    ``length``, in place, and return ``buf``.

    length: an int or 0-d tensor (one shared offset) or a (B,) tensor
    (per-slot offsets of the continuous-batching engine).  The start
    clamps to [0, L - S], as ``jax.lax.dynamic_update_slice`` clamps it."""
    S, L = val.shape[1], buf.shape[1]
    start = torch.as_tensor(length, device=buf.device).to(torch.long)
    start = start.clamp(0, L - S)
    idx = start.reshape(-1, 1) + torch.arange(S, device=buf.device)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, idx.expand(buf.shape[0], S)] = val.to(buf.dtype)
    return buf


def pos_of(length, S, device=None):
    """RoPE positions for S new tokens at offset ``length`` -> (B?, S)."""
    ar = torch.arange(S, device=device)[None, :]
    length = torch.as_tensor(length, device=device)
    if length.ndim == 0:
        return length + ar
    return length[:, None] + ar
