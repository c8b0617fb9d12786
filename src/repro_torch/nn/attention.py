"""Attention mixers: GQA with RoPE, DeepSeek-V2's multi-head latent
attention (MLA), and cross-attention into an encoder's output (the
reference's ``repro/nn/attention.py``).

Modes:
  train   — causal blockwise attention with the flash backward, no cache
            (``banded_attention`` picks the lower-triangle schedule; under
            ``remat_policy="save_attn"`` the layer's checkpoint keeps the
            flash output, ``flash.FLASH_OP``).
  bidir   — non-causal self-attention with RoPE (an encoder), GQA only.
  prefill — causal, and the layer's cache written from position 0.
  decode  — S new tokens (one, in serving) against the cache at per-slot
            offsets.  GQA's attention is kernel 5 on the card; MLA decodes
            in the absorbed (latent-space) form, plain products that never
            materialise the per-head K/V at cache length.

Cross-attention (``enc_out`` given, or a decode whose cache holds no
``k``): q from x, K and V from the encoder's output, no RoPE, not
causal.  Its weights are GQA's even under an MLA config, as in the
reference.  Prefill writes K and V into the cross cache ``ck``/``cv``
from row 0; the cross decode is kernel 5 over that cache.

A GQA layer caches K and V, (B, max_len, KV, D) each; an MLA layer the
normalised latent ``ckv`` (B, max_len, kv_lora) and the roped shared key
``kpe`` (B, max_len, rope_dim); a cross layer ``ck``/``cv`` (B,
cross_len, KV, D) and ``clen`` (B,) int32, the encoder rows each slot's
prefill wrote.  The cross decode attends to those rows only: the
reference attends to all ``cross_len`` rows, the unwritten zeros too
(ROADMAP Queue 3), and the two agree where the frames fill
``cross_len``.  ``clen`` is the port's own leaf; the reference's cache
has none.  The cache is updated in place (the serving engine owns it
preallocated, as the reference donates its cache to the jitted step) and
returned.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..core.bfp import weight_of
from . import flash
from .layers import linear, linear_init, rmsnorm, rmsnorm_init, rope
from .module import torch_dtype


def attn_init(gen, cfg: ArchConfig, cross: bool = False):
    """A layer's attention weights: MLA's where the config has it, else
    GQA's; a cross layer's (``cross``) are always GQA's."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    dtype = torch_dtype(cfg.param_dtype)
    if cfg.mla is not None and not cross:
        m = cfg.mla
        return {
            "wq": linear_init(gen, d, H * (m.qk_nope_head_dim
                                           + m.qk_rope_head_dim), dtype),
            "wdkv": linear_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                                dtype),
            "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype),
            "wuk": linear_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                               dtype),
            "wuv": linear_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype),
            "wo": linear_init(gen, H * m.v_head_dim, d, dtype),
        }
    return {
        "wq": linear_init(gen, d, H * hd, dtype, bias=cfg.qkv_bias),
        "wk": linear_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias),
        "wv": linear_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias),
        "wo": linear_init(gen, H * hd, d, dtype, bias=cfg.qkv_bias),
    }


def cross_cache_shape(cfg: ArchConfig, batch: int, cross_len: int):
    """Cache structure of one cross-attention layer: the encoder's K and V
    and each slot's count of written rows."""
    shape = (batch, cross_len, cfg.num_kv_heads, cfg.d_head)
    dt = torch_dtype(cfg.dtype)
    return {"ck": (shape, dt), "cv": (shape, dt),
            "clen": ((batch,), torch.int32)}


def attn_cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                     cross_len: int = 0):
    """Cache structure of one attention layer: {name: (shape, dtype)};
    with ``cross_len`` the cross cache's entries too."""
    dt = torch_dtype(cfg.dtype)
    if cfg.mla is not None:
        m = cfg.mla
        cache = {"ckv": ((batch, max_len, m.kv_lora_rank), dt),
                 "kpe": ((batch, max_len, m.qk_rope_head_dim), dt)}
    else:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.d_head)
        cache = {"k": (shape, dt), "v": (shape, dt)}
    if cross_len:
        cache.update(cross_cache_shape(cfg, batch, cross_len))
    return cache


def gqa_apply(p, cfg: ArchConfig, x, *, mode: str, length=None, cache=None,
              enc_out=None):
    """x (B, S, d_model) -> (y (B, S, d_model), cache); ``enc_out`` (B,
    T, d_model): cross-attention into it."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    if mode in ("train", "bidir", "prefill"):
        src = x if enc_out is None else enc_out
        T = src.shape[1]
        k = linear(p["wk"], src).reshape(B, T, KV, hd)
        v = linear(p["wv"], src).reshape(B, T, KV, hd)
        if enc_out is None:
            pos = torch.arange(S, device=x.device)[None, :]
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        o = flash.flash_attention(
            q, k, v, causal=enc_out is None and mode != "bidir",
            banded=cfg.banded_attention)
        if mode == "prefill" and cache is not None:
            if enc_out is None:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
            else:
                cache["ck"][:, :T] = k
                cache["cv"][:, :T] = v
                cache["clen"].fill_(T)
    elif mode == "decode" and enc_out is None and "k" in cache:
        k = linear(p["wk"], x).reshape(B, S, KV, hd)
        v = linear(p["wv"], x).reshape(B, S, KV, hd)
        posv = pos_of(length, S, x.device)
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
        cache_write(cache["k"], k, length)
        cache_write(cache["v"], v, length)
        o = flash.decode_attention(q, cache["k"], cache["v"], length + S)
    elif mode == "decode":              # cross decode over the encoder's rows
        o = flash.decode_attention(q, cache["ck"], cache["cv"],
                                   cache["clen"])
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


def len_mask(length, S_total: int, extra: int = 0, device=None):
    """(B?, 1, 1, S_total) validity mask of the positions < length +
    extra."""
    valid_to = torch.as_tensor(length, device=device) + extra
    if valid_to.ndim:
        valid_to = valid_to[:, None, None, None]
    return torch.arange(S_total, device=device)[None, None, None, :] \
        < valid_to


def mla_apply(p, cfg: ArchConfig, x, *, mode: str, length=None, cache=None):
    """x (B, S, d_model) -> (y (B, S, d_model), cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rdim, vdim, lora = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                              m.v_head_dim, m.kv_lora_rank)
    q = linear(p["wq"], x).reshape(B, S, H, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    dkv = linear(p["wdkv"], x)
    ckv, k_pe = dkv[..., :lora], dkv[..., lora:]
    ckv = rmsnorm(p["kv_norm"], ckv)

    if mode in ("train", "prefill"):
        pos = torch.arange(S, device=x.device)[None, :]
        q_pe = rope(q_pe, pos, cfg.rope_theta)
        k_pe = rope(k_pe[:, :, None, :], pos, cfg.rope_theta)   # (B,S,1,r)
        k_nope = linear(p["wuk"], ckv).reshape(B, S, H, nope)
        v = linear(p["wuv"], ckv).reshape(B, S, H, vdim)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, rdim)], dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        # V zero-padded to the q/k head width (flash's one width), then
        # sliced
        o = flash.flash_attention(qf, k, F.pad(v, (0, nope + rdim - vdim)),
                                  causal=True,
                                  banded=cfg.banded_attention)[..., :vdim]
        if mode == "prefill" and cache is not None:
            cache["ckv"][:, :S] = ckv
            cache["kpe"][:, :S] = k_pe[:, :, 0, :]
    elif mode == "decode":
        posv = pos_of(length, S, x.device)
        q_pe = rope(q_pe, posv, cfg.rope_theta)
        k_pe = rope(k_pe[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
        cache_write(cache["ckv"], ckv, length)
        cache_write(cache["kpe"], k_pe, length)
        o = mla_decode(p, cfg, q_nope, q_pe, cache["ckv"], cache["kpe"],
                       length)
    else:
        raise ValueError(mode)
    y = linear(p["wo"], o.reshape(B, S, H * vdim))
    return y.to(x.dtype), cache


def mla_decode(p, cfg: ArchConfig, q_nope, q_pe, ckv, kpe, length):
    """MLA's absorbed (latent-space) decode: q_nope (B, S, H, nope) and the
    roped q_pe (B, S, H, r) against the caches ckv (B, L, kv_lora) and kpe
    (B, L, r), positions < length + S valid -> o (B, S, H, v_head_dim).
    q_nope goes into the latent space through wuk; the scores are two f32
    products (latent and rope parts), scaled as a sum; the probabilities
    meet ckv in the cache's dtype, then wuv.  Per-head K and V are never
    materialised at cache length."""
    m, H = cfg.mla, cfg.num_heads
    nope, rdim, lora = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    wuk = weight_of(p["wuk"], dtype=q_nope.dtype).reshape(lora, H, nope)
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, wuk)
    s = (torch.einsum("bqhl,bsl->bhqs", q_abs.float(), ckv.float())
         + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), kpe.float()))
    s = s * ((nope + rdim) ** -0.5)
    mask = len_mask(length, ckv.shape[1], extra=q_nope.shape[1],
                    device=ckv.device)
    pr = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    lat = torch.einsum("bhqs,bsl->bqhl", pr.to(ckv.dtype), ckv)
    wuv = weight_of(p["wuv"], dtype=q_nope.dtype).reshape(lora, H,
                                                           m.v_head_dim)
    return torch.einsum("bqhl,lhv->bqhv", lat, wuv)


def mla_decode_materialised(p, cfg: ArchConfig, q_nope, q_pe, ckv, kpe,
                            length):
    """The plain version of :func:`mla_decode`, the same function in
    another order: per-head K = [ckv . wuk, kpe] and V = ckv . wuv
    materialised at cache length, then masked softmax attention in f32."""
    m, H = cfg.mla, cfg.num_heads
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    B, L, _ = ckv.shape
    dt = q_nope.dtype
    k_nope = linear(p["wuk"], ckv.to(dt)).reshape(B, L, H, nope)
    k = torch.cat([k_nope, kpe.to(dt)[:, :, None, :].expand(B, L, H, rdim)],
                  dim=-1)
    v = linear(p["wuv"], ckv.to(dt)).reshape(B, L, H, m.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) \
        * ((nope + rdim) ** -0.5)
    mask = len_mask(length, L, extra=q.shape[1], device=ckv.device)
    pr = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhqs,bshv->bqhv", pr, v.float()).to(dt)


def attn_apply(p, cfg: ArchConfig, x, *, mode: str, length=None,
               cache=None, enc_out=None):
    """The layer's mixer: MLA where the config has it, else GQA; a cross
    layer (``enc_out`` given) is GQA."""
    if cfg.mla is not None and enc_out is None:
        if mode == "bidir":
            raise ValueError("MLA encoder not supported")
        return mla_apply(p, cfg, x, mode=mode, length=length, cache=cache)
    return gqa_apply(p, cfg, x, mode=mode, length=length, cache=cache,
                     enc_out=enc_out)
