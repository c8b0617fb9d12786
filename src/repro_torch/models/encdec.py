"""Whisper-style encoder-decoder (the reference's ``repro/models/encdec.py``).

The audio frontend (mel spectrogram and conv) is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, T, d_model)
through a non-causal (``bidir``) stack with RoPE and ``enc_norm``.  The
decoder is the causal stack with a cross-attention sublayer in every
layer, into the encoder's output.  tokens (B, S) -> logits (B, S, V) f32.

Prefill writes each layer's cross cache (``ck``, ``cv``, and ``clen``,
the T encoder rows written) beside its self-attention cache; a decode
step runs kernel 5 twice a layer, over the self cache and over the
cross cache's ``clen`` rows (``nn/attention.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ArchConfig
from ..core.device import resolve_device
from ..nn.blocks import stack_apply, stack_cache_shape, stack_init
from ..nn.layers import embed_init, linear_init, norm, norm_init
from ..nn.module import shapes_only, torch_dtype
from ..parallel.sharding import layer_params
from . import lm

CROSS_LEN_DEFAULT = 1500   # whisper: 30 s of audio -> 1,500 frames


def enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's config: ``encoder_layers`` layers, no cross-attention,
    no MoE."""
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers,
                               cross_attention=False, moe=None)


def init(seed_or_generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """Random parameters, the reference's scheme and tree, drawn as
    ``lm.init`` draws them."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    dtype = torch_dtype(cfg.param_dtype)
    with shapes_only(dev):
        p = {"enc_stack": stack_init(gen, enc_cfg(cfg)),
             "enc_norm": norm_init(cfg.norm_type, cfg.d_model, dtype),
             "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
             "dec_stack": stack_init(gen, cfg),
             "final_norm": norm_init(cfg.norm_type, cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    return lm.to_device(p, dev)


def params_from_reference(np_params, cfg: ArchConfig, *, device="cuda"):
    """Carry the reference's parameters (``repro.models.encdec.init``'s
    pytree, as numpy arrays) into the port's, each stack unstacked into
    its layer list."""
    p = dict(np_params,
             enc_stack=lm._reference_layers(np_params["enc_stack"],
                                            enc_cfg(cfg)),
             dec_stack=lm._reference_layers(np_params["dec_stack"], cfg))
    return lm._tensors(p, device)


def to_reference_layout(tree, cfg: ArchConfig, *, device=None) -> dict:
    """A params-shaped tree (params, grads, AdamW moments) in the
    reference's layout: each stack laid out as ``lm.to_reference_layout``
    lays an LM's (the encoder's at :func:`enc_cfg`)."""
    def stacked(key, c):
        return lm.to_reference_layout({"stack": tree[key]}, c,
                                      device=device)["stack"]
    return dict(tree, enc_stack=stacked("enc_stack", enc_cfg(cfg)),
                dec_stack=stacked("dec_stack", cfg))


def from_reference_layout(tree, cfg: ArchConfig) -> dict:
    """The inverse of :func:`to_reference_layout` (views, no copy)."""
    return dict(tree,
                enc_stack=lm._reference_layers(tree["enc_stack"],
                                               enc_cfg(cfg)),
                dec_stack=lm._reference_layers(tree["dec_stack"], cfg))


def cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                cross_len: int = CROSS_LEN_DEFAULT):
    """The decoder's per-layer caches: self-attention's K and V of
    ``max_len`` positions and the cross cache of ``cross_len`` rows."""
    return stack_cache_shape(cfg, batch, max_len, cross_len=cross_len)


def cache_init(cfg: ArchConfig, batch: int, max_len: int, *,
               cross_len: int = CROSS_LEN_DEFAULT, device="cuda"):
    return lm.zero_caches(cache_shape(cfg, batch, max_len, cross_len),
                          device)


def encode(params, cfg: ArchConfig, frames):
    """frames (B, T, d_model) -> the encoder's output (B, T, d_model) in
    ``cfg.dtype``."""
    x = frames.to(torch_dtype(cfg.dtype))
    x, _, _ = stack_apply(params["enc_stack"], enc_cfg(cfg), x,
                          mode="bidir")
    return norm(cfg.norm_type, layer_params(params["enc_norm"]), x)


def apply(params, cfg: ArchConfig, tokens, *, frames=None, enc_out=None,
          mode: str = "train", length=None, caches=None,
          collect_aux: bool = False):
    """tokens (B, S) -> (logits (B, S, V) f32, caches, aux).  ``frames``
    are encoded unless ``enc_out`` is given; train and prefill need one
    of them, a decode reads the cross cache instead."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if enc_out is None and frames is not None:
        enc_out = encode(params, cfg, frames)
    x = lm.embed_tokens(params, cfg, tokens)
    x, new_caches, aux = stack_apply(params["dec_stack"], cfg, x, mode=mode,
                                     length=length, caches=caches,
                                     enc_out=enc_out,
                                     collect_aux=collect_aux)
    x = norm(cfg.norm_type, layer_params(params["final_norm"]), x)
    return lm._readout(params, cfg, x), new_caches, aux


def loss_fn(params, cfg: ArchConfig, batch, collect_aux: bool = True):
    """batch: {"frames": (B, T, d), "inputs": (B, S), "targets": (B, S)};
    targets < 0 are masked.  Returns (loss + aux, metrics)."""
    logits, _, aux = apply(params, cfg, batch["inputs"],
                           frames=batch["frames"], mode="train",
                           collect_aux=collect_aux)
    return lm._ce(logits, batch["targets"], aux, lm.vocab_share(cfg))
