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

:func:`attn_apply_tp` is the tensor-parallel mixer over ``model``, in the
reference's two regimes (``parallel.sharding.heads_parallel``): where the
heads divide, each rank computes its heads (its block of ``wq``; its KV
heads where those divide too, else the K/V columns gathered and the KV
heads its q heads read taken) and ``wo`` on its rows gives its partial
sum; elsewhere the attention weights are gathered whole and the rank
computes its block of q rows (``seq_res``, flash at ``q_offset``) against
the whole K/V.  A cache leaf holds the rank's block of rows
(``cache_seq``; ``sharding.cache_block``): prefill writes it (its KV
heads' rows sent to their ranks by an all-to-all where the KV heads are
split), a decode writes the new row where it falls and runs kernel 5 over
the block at the local length clamp(length - rank x block, 0, block), and
the ranks' outputs merge by their log-sum-exp.  MLA splits its heads the
same way; its latent cache is split by rows alike and its absorbed decode
merges each block's latent by its log-sum-exp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..core.bfp import weight_of
from ..kernels.decode_attn.ref import merge_blocks
from ..parallel import collectives as coll
from ..parallel.sharding import cache_block, heads_parallel, splits
from . import flash
from .layers import (block, linear, linear_cols, linear_init, linear_rows,
                     linear_whole, rmsnorm, rmsnorm_init, rope, weight_block)
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


# --- tensor-parallel compute over "model" ------------------------------------
def attn_apply_tp(p, cfg: ArchConfig, x, share, *, mode: str, length=None,
                  cache=None, enc_out=None):
    """:func:`attn_apply` on the rank's block -> (y, kind, cache): kind
    "partial" (the rank's partial sum of every row), "rows" (the rank's
    block of rows, whole) or "full" (every row, whole, alike on every
    rank).  ``x`` holds every row."""
    if cfg.mla is not None and enc_out is None:
        if mode == "bidir":
            raise ValueError("MLA encoder not supported")
        return _mla_tp(p, cfg, x, share, mode=mode, length=length,
                       cache=cache)
    if mode == "decode":
        return _gqa_decode_tp(p, cfg, x, share, length, cache)
    return _gqa_tp(p, cfg, x, share, mode=mode, cache=cache,
                   enc_out=enc_out)


def _q_rows(x, S: int, share):
    """(rows of q, their offset, kind): the rank's block of rows where the
    rules split ``seq_res``, else every row."""
    if splits("seq_res", S):
        return coll.split(x, 1, share), share.block(S)[0], "rows"
    return x, 0, "full"


def _kv_heads(H: int, KV: int, share) -> tuple:
    """[lo, hi) of the KV heads the rank's block of q heads reads."""
    G, Hl = H // KV, H // share.size
    h0 = share.rank * Hl
    lo, hi = h0 // G, (h0 + Hl - 1) // G + 1
    if Hl % (hi - lo):
        raise NotImplementedError(f"{Hl} q heads a rank over {hi - lo} KV "
                                  "heads")
    return lo, hi


def _cols_whole(p, x, n_out: int, share):
    """``x`` times the whole weight by columns, autograd-aware: the
    rank's column block where the leaf is one, the columns gathered."""
    w = weight_of(p, "w", dtype=x.dtype)
    y = x @ w
    if w.shape[1] != n_out:
        y = coll.gather(y, -1, share)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _out_proj(p, o, n_in: int, share):
    """(y, kind) of ``o``, every rank's whole attention output features:
    ``wo`` on the rank's rows where ``qkv_flat`` splits, else whole."""
    if splits("qkv_flat", n_in):
        lo, hi = share.block(n_in)
        return linear_rows(p, o[..., lo:hi], n_in, share), "partial"
    return linear(p, o), "full"


def _write_rows(cache, name: str, val, share):
    """Rows [0, T) of ``val`` (B, T, ...), every rank's whole, into the
    rank's block of cache leaf ``name``."""
    loc, shape = cache_block(cache[name], name, share)
    T, L, Lb = val.shape[1], shape[1], loc.shape[1]
    lo = share.rank * Lb if Lb != L else 0
    n = max(0, min(T - lo, Lb))
    loc[:, :n] = val[:, lo:lo + n].detach().to(loc.dtype)


def _write_heads(cache, name: str, val, share):
    """``val`` (B, T, KV / m, D), the rank's KV heads at every row, into
    the rank's block of rows of cache leaf ``name`` (every KV head): an
    all-to-all over ``model`` (heads to rows), or an all-gather of the
    heads where the cache is whole on every rank."""
    loc, shape = cache_block(cache[name], name, share)
    B, T = val.shape[:2]
    L, Lb, m = shape[1], loc.shape[1], share.size
    val = val.detach().to(loc.dtype)
    if Lb == L:
        loc[:, :T] = coll.gather_nograd(val, 2, share)
        return
    send = F.pad(val, (0, 0, 0, 0, 0, L - T)).reshape(
        B, m, Lb, *val.shape[2:]).movedim(1, 0)
    recv = coll.heads_to_rows(send, share)        # (m src, B, Lb, KV/m, D)
    rows = recv.permute(1, 2, 0, 3, 4).reshape(B, Lb, -1, val.shape[-1])
    n = max(0, min(T - share.rank * Lb, Lb))
    loc[:, :n] = rows[:, :n]


def _gqa_tp(p, cfg: ArchConfig, x, share, *, mode: str, cache=None,
            enc_out=None):
    B, S, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    src = x if enc_out is None else enc_out
    T = src.shape[1]
    causal = enc_out is None and mode != "bidir"
    heads_mine, sel = False, None
    if heads_parallel(H, share):
        Hl, q_off, kind = H // share.size, 0, "partial"
        q = linear_cols(p["wq"], x, H * hd, share).reshape(B, S, Hl, hd)
        heads_mine = KV % share.size == 0
        if heads_mine:
            k = linear_cols(p["wk"], src, KV * hd, share)
            v = linear_cols(p["wv"], src, KV * hd, share)
        else:       # the K/V columns gathered; the KV heads q reads taken
            k = _cols_whole(p["wk"], src, KV * hd, share)
            v = _cols_whole(p["wv"], src, KV * hd, share)
            sel = _kv_heads(H, KV, share)
    else:
        xq, q_off, kind = _q_rows(x, S, share)
        q = linear_whole(p["wq"], xq, d, H * hd, share).reshape(B, -1, H, hd)
        k = linear_whole(p["wk"], src, d, KV * hd, share)
        v = linear_whole(p["wv"], src, d, KV * hd, share)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
    if enc_out is None:
        qpos = q_off + torch.arange(q.shape[1], device=x.device)[None, :]
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, torch.arange(T, device=x.device)[None, :],
                 cfg.rope_theta)
    kq, vq = (k, v) if sel is None else (k[:, :, sel[0]:sel[1]],
                                         v[:, :, sel[0]:sel[1]])
    o = flash.flash_attention(q, kq, vq, causal=causal, q_offset=q_off,
                              banded=cfg.banded_attention)
    if mode == "prefill" and cache is not None:
        names = ("k", "v") if enc_out is None else ("ck", "cv")
        write = _write_heads if heads_mine else _write_rows
        write(cache, names[0], k, share)
        write(cache, names[1], v, share)
        if enc_out is not None:
            cache_block(cache["clen"], "clen", share)[0].fill_(T)
    o = o.reshape(B, q.shape[1], -1)
    if kind == "partial":
        y = linear_rows(p["wo"], o, H * hd, share)
    else:
        y = linear_whole(p["wo"], o, H * hd, d, share)
    return y.to(x.dtype), kind, cache


def _block_length(length, S: int, loc, shape, share):
    """(the rank's block start, its valid rows) of a cache split along
    rows: clamp(length + S - start, 0, block)."""
    L, Lb = shape[1], loc.shape[1]
    lo = share.rank * Lb if Lb != L else 0
    n = torch.as_tensor(length, device=loc.device) + S - lo
    return lo, n.clamp(0, Lb)


def _write_new(loc, val, length, lo: int):
    """The new rows ``val`` (B, S, ...) at positions length + [0, S) into
    the block ``loc`` of rows [lo, lo + block), where they fall in it (a
    row elsewhere writes the value it finds back: no data-dependent
    shapes, so the dry run counts it on meta)."""
    B, S = val.shape[:2]
    start = torch.as_tensor(length, device=loc.device).reshape(-1) - lo
    rows = torch.arange(B, device=loc.device)
    for j in range(S):
        pos = (start + j).expand(B)
        ok = (pos >= 0) & (pos < loc.shape[1])
        at = pos.clamp(0, loc.shape[1] - 1)
        new = val[:, j].to(loc.dtype)
        ok = ok.reshape((B,) + (1,) * (new.ndim - 1))
        loc[rows, at] = torch.where(ok, new, loc[rows, at])


def _attend_blocks(q, kl, vl, n, share, split: bool):
    """Kernel 5 over the rank's block (``n`` valid rows a slot), merged
    over the ranks by the log-sum-exp where the cache is split."""
    if not split:
        return flash.decode_attention(q, kl, vl, n)
    o, lse = flash.decode_attention(q, kl.contiguous(), vl.contiguous(), n,
                                    return_lse=True)
    outs = coll.gather_nograd(o[None], 0, share)
    lses = coll.gather_nograd(lse[None], 0, share)
    return merge_blocks(outs, lses)[0]


def _gqa_decode_tp(p, cfg: ArchConfig, x, share, length, cache):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = _cols_whole(p["wq"], x, H * hd, share).reshape(B, S, H, hd)
    if "k" in cache:
        knew = _cols_whole(p["wk"], x, KV * hd, share).reshape(B, S, KV,
                                                                   hd)
        vnew = _cols_whole(p["wv"], x, KV * hd, share).reshape(B, S, KV,
                                                                   hd)
        posv = pos_of(length, S, x.device)
        q = rope(q, posv, cfg.rope_theta)
        knew = rope(knew, posv, cfg.rope_theta)
        kl, shape = cache_block(cache["k"], "k", share)
        vl, _ = cache_block(cache["v"], "v", share)
        lo, n = _block_length(length, S, kl, shape, share)
        _write_new(kl, knew, length, lo)
        _write_new(vl, vnew, length, lo)
    else:                               # cross decode over the encoder's rows
        kl, shape = cache_block(cache["ck"], "ck", share)
        vl, _ = cache_block(cache["cv"], "cv", share)
        clen = cache_block(cache["clen"], "clen", share)[0]
        lo, n = _block_length(clen, 0, kl, shape, share)
    o = _attend_blocks(q, kl, vl, n, share, kl.shape[1] != shape[1])
    y, kind = _out_proj(p["wo"], o.reshape(B, S, H * hd), H * hd, share)
    return y.to(x.dtype), kind, cache


def _block_softmax(s, mask):
    """(probabilities, lse) of scores ``s`` (B, H, S, L) over the valid
    ``mask`` columns of a block; a row with none gives 0 and -inf."""
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * mask
    den = e.sum(dim=-1, keepdim=True)
    lse = torch.where(mask.any(-1), (m + torch.log(den))[..., 0], -torch.inf)
    return e / den.clamp(min=1e-30), lse



def _mla_tp(p, cfg: ArchConfig, x, share, *, mode: str, length=None,
            cache=None):
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.num_heads
    nope, rdim, vdim, lora = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                              m.v_head_dim, m.kv_lora_rank)
    qk = nope + rdim
    hp = heads_parallel(H, share)
    dkv = linear(p["wdkv"], x)
    ckv, k_pe = dkv[..., :lora], dkv[..., lora:]
    ckv = rmsnorm(p["kv_norm"], ckv)
    if mode == "decode":
        return _mla_decode_tp(p, cfg, x, share, ckv, k_pe, length, cache)
    if mode not in ("train", "prefill"):
        raise ValueError(mode)
    if hp:
        xq, q_off, kind = x, 0, "partial"
        Hl = H // share.size
        q = linear_cols(p["wq"], x, H * qk, share).reshape(B, S, Hl, qk)
        k_nope = linear_cols(p["wuk"], ckv, H * nope, share).reshape(
            B, S, Hl, nope)
        v = linear_cols(p["wuv"], ckv, H * vdim, share).reshape(B, S, Hl,
                                                                 vdim)
    else:
        xq, q_off, kind = _q_rows(x, S, share)
        Hl = H
        q = linear_whole(p["wq"], xq, d, H * qk, share).reshape(B, -1, H, qk)
        k_nope = linear_whole(p["wuk"], ckv, lora, H * nope, share).reshape(
            B, S, H, nope)
        v = linear_whole(p["wuv"], ckv, lora, H * vdim, share).reshape(
            B, S, H, vdim)
    Sq = q.shape[1]
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = rope(q_pe, q_off + torch.arange(Sq, device=x.device)[None, :],
                cfg.rope_theta)
    pos = torch.arange(S, device=x.device)[None, :]
    k_pe = rope(k_pe[:, :, None, :], pos, cfg.rope_theta)      # (B,S,1,r)
    k = torch.cat([k_nope, k_pe.expand(B, S, Hl, rdim)], dim=-1)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    o = flash.flash_attention(qf, k, F.pad(v, (0, qk - vdim)), causal=True,
                              q_offset=q_off,
                              banded=cfg.banded_attention)[..., :vdim]
    if mode == "prefill" and cache is not None:
        _write_rows(cache, "ckv", ckv, share)
        _write_rows(cache, "kpe", k_pe[:, :, 0, :], share)
    o = o.reshape(B, Sq, Hl * vdim)
    if kind == "partial":
        y = linear_rows(p["wo"], o, H * vdim, share)
    else:
        y = linear_whole(p["wo"], o, H * vdim, d, share)
    return y.to(x.dtype), kind, cache


def _mla_decode_tp(p, cfg: ArchConfig, x, share, ckv, k_pe, length, cache):
    """MLA's absorbed decode over the rank's block of the latent cache:
    each head's latent over the block, merged over the ranks by its
    log-sum-exp, then ``wuv`` and ``wo`` on the rank's heads."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rdim, vdim, lora = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                              m.v_head_dim, m.kv_lora_rank)
    hp = heads_parallel(H, share)
    q = _cols_whole(p["wq"], x, H * (nope + rdim), share).reshape(
        B, S, H, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    posv = pos_of(length, S, x.device)
    q_pe = rope(q_pe, posv, cfg.rope_theta)
    k_pe = rope(k_pe[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
    cl, shape = cache_block(cache["ckv"], "ckv", share)
    kl, _ = cache_block(cache["kpe"], "kpe", share)
    lo, n = _block_length(length, S, cl, shape, share)
    _write_new(cl, ckv, length, lo)
    _write_new(kl, k_pe, length, lo)
    if hp:
        h0, h1 = share.block(H)
        wuk = weight_block(p["wuk"], "w", 1, H * nope, share, x.dtype)
        q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope[:, :, h0:h1],
                             wuk.reshape(lora, h1 - h0, nope))
        q_abs = coll.gather_nograd(q_abs, 2, share)
    else:
        wuk = block(weight_of(p["wuk"], dtype=x.dtype), 1, H * nope, share,
                    whole=True)
        q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope,
                             wuk.reshape(lora, H, nope))
    s = (torch.einsum("bqhl,bsl->bhqs", q_abs.float(), cl.float())
         + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), kl.float()))
    s = s * ((nope + rdim) ** -0.5)
    nn_ = n if n.ndim == 0 else n[:, None, None, None]
    mask = torch.arange(cl.shape[1], device=x.device) < nn_
    if cl.shape[1] != shape[1]:
        pr, lse = _block_softmax(s, mask.expand_as(s))
        lat = torch.einsum("bhqs,bsl->bqhl", pr.to(cl.dtype), cl)
        lat = merge_blocks(coll.gather_nograd(lat[None], 0, share),
                           coll.gather_nograd(lse[..., 0][None], 0,
                                              share))[0]
    else:
        pr = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        lat = torch.einsum("bhqs,bsl->bqhl", pr.to(cl.dtype), cl)
    if hp:
        wuv = weight_block(p["wuv"], "w", 1, H * vdim, share, x.dtype)
        o = torch.einsum("bqhl,lhv->bqhv", lat[:, :, h0:h1],
                         wuv.reshape(lora, h1 - h0, vdim))
        y = linear_rows(p["wo"], o.reshape(B, S, -1), H * vdim, share)
        return y.to(x.dtype), "partial", cache
    wuv = block(weight_of(p["wuv"], dtype=x.dtype), 1, H * vdim, share,
                whole=True)
    o = torch.einsum("bqhl,lhv->bqhv", lat, wuv.reshape(lora, H, vdim))
    y, kind = _out_proj(p["wo"], o.reshape(B, S, H * vdim), H * vdim, share)
    return y.to(x.dtype), kind, cache
