"""Residual blocks and the layer stack (the reference's
``repro/nn/blocks.py``).

The reference runs its dense-prefix layers (``first_k_dense``) unrolled
and scans one compiled block body (one pattern period) over stacked
parameters for the rest; the port runs eagerly, so the stack is a Python
loop over a list of per-layer parameter dicts in layer order
(``models.lm.params_from_reference`` unstacks the reference's).  A
layer's mixer is attention (GQA or MLA) or the Mamba-2 SSM, its FFN a
dense MLP, a mixture of experts (``nn/moe.py``) or none: deepseek's layer
0 is ("attn", "mlp"), layers 1-26 ("attn", "moe").  Under
``cross_attention`` (a decoder of the encoder-decoder family) each layer
has a cross-attention sublayer (``normx``, ``xattn``) between the mixer
and the FFN, run when ``enc_out`` is given or the layer's cache holds
``xattn``: mode ``decode`` in a decode, else ``prefill`` (which writes
the cross cache where there is one).

Under ``cfg.remat`` in train and bidir mode each layer runs inside
``torch.utils.checkpoint.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, one layer at a time, as the reference's
``jax.checkpoint`` of its period-1 scan group does.  With
``remat_policy="save_attn"`` selective checkpointing keeps the flash
attention's output (``flash.FLASH_OP``), so the recompute skips it.

A layer takes its parameters through ``sharding.layer_params`` on entry:
under ``--fsdp`` placements each leaf split over "data" is gathered
there, inside the layer and so inside its checkpoint: the gathered
blocks are never saved, the recompute gathers again, and the backward
reduce-scatters their gradients (the reference's per-layer all-gathers
inside its scan body).  Any other leaf passes as it is.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import ArchConfig
from ..core.opcount import marks_layer
from ..parallel import collectives as coll
from ..parallel.sharding import layer_params, model_share, splits
from .attention import (attn_apply, attn_apply_tp, attn_cache_shape,
                        attn_init, cross_cache_shape)
from .flash import FLASH_OP
from .layers import norm, norm_init
from .mlp import mlp_apply, mlp_apply_tp, mlp_init
from .moe import moe_apply, moe_apply_tp, moe_init
from .module import torch_dtype
from .ssd import mamba_apply, mamba_apply_tp, mamba_init, ssm_cache_shape


def _check_kind(ffn: str):
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown ffn kind {ffn!r}")


def block_init(gen, cfg: ArchConfig, mixer: str, ffn: str):
    dtype = torch_dtype(cfg.param_dtype)
    p = {"norm1": norm_init(cfg.norm_type, cfg.d_model, dtype)}
    if mixer == "attn":
        p["attn"] = attn_init(gen, cfg)
    else:
        p["ssm"] = mamba_init(gen, cfg)
    if cfg.cross_attention:
        p["normx"] = norm_init(cfg.norm_type, cfg.d_model, dtype)
        p["xattn"] = attn_init(gen, cfg, cross=True)
    if ffn != "none":
        p["norm2"] = norm_init(cfg.norm_type, cfg.d_model, dtype)
        p[ffn] = mlp_init(gen, cfg) if ffn == "mlp" else moe_init(gen, cfg)
    return p


@marks_layer
def block_apply(p, cfg: ArchConfig, x, *, mixer: str, ffn: str, mode: str,
                length=None, cache=None, enc_out=None,
                collect_aux: bool = False):
    """x (B, S, d_model) -> (x, cache, aux); aux is the MoE router loss
    under ``collect_aux``, else 0.  ``stack_kinds`` has checked the
    kind."""
    p = layer_params(p)
    h = norm(cfg.norm_type, p["norm1"], x)
    if mixer == "attn":
        h, c = attn_apply(p["attn"], cfg, h, mode=mode, length=length,
                          cache=None if cache is None else cache["attn"])
    else:       # the SSM carries its own position in its state
        h, c = mamba_apply(p["ssm"], cfg, h,
                           mode="train" if mode == "bidir" else mode,
                           cache=None if cache is None else cache["ssm"])
    x = x + h
    new_cache = None if cache is None else {mixer: c}
    xc = None if cache is None else cache.get("xattn")
    if cfg.cross_attention and "xattn" in p and (enc_out is not None
                                                 or xc is not None):
        h, xc = attn_apply(p["xattn"], cfg,
                           norm(cfg.norm_type, p["normx"], x),
                           mode="decode" if mode == "decode" else "prefill",
                           length=length, cache=xc, enc_out=enc_out)
        x = x + h
        if new_cache is not None and xc is not None:
            new_cache["xattn"] = xc
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "mlp":
        x = x + mlp_apply(p["mlp"], cfg, norm(cfg.norm_type, p["norm2"], x))
    elif ffn == "moe":
        h, a = moe_apply(p["moe"], cfg, norm(cfg.norm_type, p["norm2"], x),
                         return_aux=collect_aux)
        x = x + h
        if a is not None:
            aux = a
    return x, new_cache, aux


def _settle(y, kind: str, rows: bool, share):
    """A sublayer's output ``y`` as the residual holds it: the rank's rows
    (``rows``) or every row."""
    if kind == "partial":
        return (coll.reduce_scatter(y, 1, share) if rows
                else coll.reduce_sum(y, share))
    if kind == "full" and rows:
        return coll.split(y, 1, share)
    return y


@marks_layer
def block_apply_tp(p, cfg: ArchConfig, x, share, *, mixer: str, ffn: str,
                   mode: str, rows: bool, length=None, cache=None,
                   enc_out=None, collect_aux: bool = False):
    """:func:`block_apply` on the rank's blocks: ``x`` the residual, the
    rank's block of rows where ``rows``, else every row."""
    p = layer_params(p)

    def whole(h):
        return coll.gather(h, 1, share) if rows else h

    h = whole(norm(cfg.norm_type, p["norm1"], x))
    if mixer == "attn":
        h, kind, c = attn_apply_tp(
            p["attn"], cfg, h, share, mode=mode, length=length,
            cache=None if cache is None else cache["attn"])
    else:
        h, kind, c = mamba_apply_tp(
            p["ssm"], cfg, h, share,
            mode="train" if mode == "bidir" else mode,
            cache=None if cache is None else cache["ssm"])
    x = x + _settle(h, kind, rows, share)
    new_cache = None if cache is None else {mixer: c}
    xc = None if cache is None else cache.get("xattn")
    if cfg.cross_attention and "xattn" in p and (enc_out is not None
                                                 or xc is not None):
        h, kind, xc = attn_apply_tp(
            p["xattn"], cfg, whole(norm(cfg.norm_type, p["normx"], x)),
            share, mode="decode" if mode == "decode" else "prefill",
            length=length, cache=xc, enc_out=enc_out)
        x = x + _settle(h, kind, rows, share)
        if new_cache is not None and xc is not None:
            new_cache["xattn"] = xc
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "mlp":
        h, kind = mlp_apply_tp(p["mlp"], cfg,
                               whole(norm(cfg.norm_type, p["norm2"], x)),
                               share)
        x = x + _settle(h, kind, rows, share)
    elif ffn == "moe":
        h, kind, a = moe_apply_tp(p["moe"], cfg,
                                  whole(norm(cfg.norm_type, p["norm2"], x)),
                                  share, return_aux=collect_aux)
        x = x + _settle(h, kind, rows, share)
        if a is not None:
            aux = a
    return x, new_cache, aux


def stack_kinds(cfg: ArchConfig):
    """(mixer, ffn) of every layer, in order: the dense prefix
    (``first_k_dense``) and then the repeating pattern."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    for _, ffn in kinds:
        _check_kind(ffn)
    return kinds


def stack_init(gen, cfg: ArchConfig):
    return [block_init(gen, cfg, *kind) for kind in stack_kinds(cfg)]


def block_cache_shape(cfg: ArchConfig, mixer: str, batch: int,
                      max_len: int, cross_len: int = 0):
    c = ({"attn": attn_cache_shape(cfg, batch, max_len)} if mixer == "attn"
         else {"ssm": ssm_cache_shape(cfg, batch)})
    if cfg.cross_attention and cross_len:
        c["xattn"] = cross_cache_shape(cfg, batch, cross_len)
    return c


def stack_cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                      cross_len: int = 0):
    return [block_cache_shape(cfg, mixer, batch, max_len, cross_len)
            for mixer, _ in stack_kinds(cfg)]


def _save_attn(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is FLASH_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return create_selective_checkpoint_contexts(_save_attn)


def _remat_block(bp, x, enc_out, cfg, mixer, ffn, mode, collect_aux):
    x, _, aux = block_apply(bp, cfg, x, mixer=mixer, ffn=ffn, mode=mode,
                            enc_out=enc_out, collect_aux=collect_aux)
    return x, aux


def _remat_block_tp(bp, x, enc_out, cfg, mixer, ffn, mode, collect_aux,
                    share, rows):
    x, _, aux = block_apply_tp(bp, cfg, x, share, mixer=mixer, ffn=ffn,
                               mode=mode, rows=rows, enc_out=enc_out,
                               collect_aux=collect_aux)
    return x, aux


def _remat_kwargs(cfg: ArchConfig) -> dict:
    """``checkpoint``'s keyword arguments for ``cfg.remat_policy``."""
    if cfg.remat_policy == "save_attn":
        return {"use_reentrant": False, "context_fn": _remat_context}
    if cfg.remat_policy == "nothing":
        return {"use_reentrant": False}
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def stack_apply(params, cfg: ArchConfig, x, *, mode: str, length=None,
                caches=None, enc_out=None, collect_aux: bool = False):
    """Every layer in order -> (x, caches, aux); aux, the MoE router loss
    summed over the layers under ``collect_aux``, is 0 otherwise;
    ``enc_out`` goes to every layer's cross-attention.  Under a ``model``
    share the stack runs :func:`block_apply_tp`; ``x`` comes in and goes
    out whole on every rank."""
    share = model_share()
    if share is not None:
        return _stack_apply_tp(params, cfg, x, share, mode=mode,
                               length=length, caches=caches, enc_out=enc_out,
                               collect_aux=collect_aux)
    new_caches = None if caches is None else []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat and mode in ("train", "bidir")
             and torch.is_grad_enabled())
    kw = _remat_kwargs(cfg) if remat else None
    for i, ((mixer, ffn), bp) in enumerate(zip(stack_kinds(cfg), params)):
        if remat:
            x, aux = checkpoint(functools.partial(
                _remat_block, cfg=cfg, mixer=mixer, ffn=ffn, mode=mode,
                collect_aux=collect_aux), bp, x, enc_out, **kw)
        else:
            x, c, aux = block_apply(
                bp, cfg, x, mixer=mixer, ffn=ffn, mode=mode, length=length,
                cache=None if caches is None else caches[i],
                enc_out=enc_out, collect_aux=collect_aux)
            if new_caches is not None:
                new_caches.append(c)
        aux_total = aux_total + aux
    return x, new_caches, aux_total


def _stack_apply_tp(params, cfg: ArchConfig, x, share, *, mode: str,
                    length=None, caches=None, enc_out=None,
                    collect_aux: bool = False):
    rows = mode != "decode" and splits("seq_res", x.shape[1])
    if rows:
        x = coll.split(x, 1, share)
    new_caches = None if caches is None else []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat and mode in ("train", "bidir")
             and torch.is_grad_enabled())
    kw = _remat_kwargs(cfg) if remat else None
    for i, ((mixer, ffn), bp) in enumerate(zip(stack_kinds(cfg), params)):
        if remat:
            x, aux = checkpoint(functools.partial(
                _remat_block_tp, cfg=cfg, mixer=mixer, ffn=ffn, mode=mode,
                collect_aux=collect_aux, share=share, rows=rows), bp, x,
                enc_out, **kw)
        else:
            x, c, aux = block_apply_tp(
                bp, cfg, x, share, mixer=mixer, ffn=ffn, mode=mode,
                rows=rows, length=length,
                cache=None if caches is None else caches[i],
                enc_out=enc_out, collect_aux=collect_aux)
            if new_caches is not None:
                new_caches.append(c)
        aux_total = aux_total + aux
    if rows:
        x = coll.gather(x, 1, share)
    return x, new_caches, aux_total
