"""Phi-3-vision-style vision-language model (the reference's
``repro/models/vlm.py``): the phi-3 decoder with a stubbed CLIP frontend.

As in the reference, the vision tower is a stub: the caller gives
precomputed patch embeddings (B, P, ``CLIP_DIM``), cast to ``cfg.dtype``,
projected by ``patch_proj`` and prepended to the token sequence.  The
logits and the loss cover the token positions only.  The cache holds the
patch prefix and the text: ``num_patches + max_len`` positions a slot,
and a decode's ``length`` counts the prefix.
"""
from __future__ import annotations

import torch

from ..config import ArchConfig
from ..core.device import resolve_device
from ..nn.blocks import stack_apply, stack_cache_shape, stack_init
from ..nn.layers import embed_init, linear, linear_init, norm, norm_init
from ..nn.module import shapes_only, torch_dtype
from ..parallel.sharding import layer_params
from . import lm

CLIP_DIM = 1024


def init(seed_or_generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """Random parameters, the reference's scheme and tree, drawn as
    ``lm.init`` draws them."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    dtype = torch_dtype(cfg.param_dtype)
    with shapes_only(dev):
        p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
             "patch_proj": linear_init(gen, CLIP_DIM, cfg.d_model, dtype),
             "stack": stack_init(gen, cfg),
             "final_norm": norm_init(cfg.norm_type, cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    return lm.to_device(p, dev)


def params_from_reference(np_params, cfg: ArchConfig, *, device="cuda"):
    """Carry the reference's parameters (``repro.models.vlm.init``'s
    pytree, as numpy arrays) into the port's."""
    return lm.params_from_reference(np_params, cfg, device=device)


# the reference lays the stack out as an LM's, the patch projection beside
to_reference_layout = lm.to_reference_layout
from_reference_layout = lm.from_reference_layout


def cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    """Per-layer caches of the patch prefix and ``max_len`` text
    positions."""
    return stack_cache_shape(cfg, batch, cfg.num_patches + max_len)


def cache_init(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    return lm.zero_caches(cache_shape(cfg, batch, max_len), device)


def apply(params, cfg: ArchConfig, tokens, *, patches=None,
          mode: str = "train", length=None, caches=None,
          collect_aux: bool = False):
    """tokens (B, S), patches (B, P, CLIP_DIM) or None -> (logits (B, S,
    V) f32 over the token positions, caches, aux)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    dt = torch_dtype(cfg.dtype)
    x = lm.embed_tokens(params, cfg, tokens)
    n_patch = 0
    if patches is not None:
        pe = linear(layer_params(params["patch_proj"]), patches.to(dt))
        x = torch.cat([pe, x], dim=1)
        n_patch = pe.shape[1]
    x, new_caches, aux = stack_apply(params["stack"], cfg, x, mode=mode,
                                     length=length, caches=caches,
                                     collect_aux=collect_aux)
    x = norm(cfg.norm_type, layer_params(params["final_norm"]),
             x[:, n_patch:])
    return lm._readout(params, cfg, x), new_caches, aux


def loss_fn(params, cfg: ArchConfig, batch, collect_aux: bool = True):
    """batch: {"patches": (B, P, 1024), "inputs": (B, S), "targets": (B,
    S)}; targets < 0 are masked.  Returns (loss + aux, metrics)."""
    logits, _, aux = apply(params, cfg, batch["inputs"],
                           patches=batch["patches"], mode="train",
                           collect_aux=collect_aux)
    return lm._ce(logits, batch["targets"], aux, lm.vocab_share(cfg))
