"""Decoder-only language model, the dense, SSM, mixture-of-experts and
hybrid families (the reference's ``repro/models/lm.py``).

tokens (B, S) -> logits (B, S, V) f32 through embed, the layer stack, the
final norm and the readout: tied (``embed_attend``), an untied
``lm_head``, or, under ``fc_bfp``, the untied head streamed as int8 BFP
through kernel 4 (``kernels/bfp_matmul``), the paper's §3.6 FC regime.
Parameters are nested dicts of tensors with ``stack`` a list of per-layer
dicts; :func:`params_from_reference` carries the reference's parameters
(its dense-prefix layers and scan-stacked groups) over, and
:func:`to_reference_layout` /
:func:`from_reference_layout` convert any params-shaped tree (params,
grads, AdamW moments) to and from the reference's stacked layout, which
the trainer's checkpoints use.  :func:`quantize_linear_tree` compresses
the large linears to shared-exponent int8 blocks (the reference's
``bfp8`` serving weights), which ``nn.layers.linear`` and
``core.bfp.weight_of`` dequantize.  :func:`loss_fn` is the reference's
masked cross entropy with its metrics (plus the MoE router loss).

Under tensor-parallel compute over ``model`` (an active DeviceMesh whose
``model`` axis has more than one rank, where the rules split the
vocabulary) the embedding is looked up in each rank's rows and summed,
the readout gives the rank's block of the vocabulary's logits (an untied
``lm_head``, which no rule splits, is cut to its columns; under
``fc_bfp`` kernel 4 runs on them), :func:`_ce` takes its max, sum of
exponentials and label logit across the ranks, and :func:`greedy` the
lowest index among the maxima across them.  The leaves outside the
stack (the embedding, the final norm, the readout) pass through
``sharding.layer_params`` at each use, as the layers' do: under
``--fsdp`` placements each is gathered over "data" there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ArchConfig
from ..core import bfp
from ..core.device import resolve_device
from ..kernels.bfp_matmul.ops import bfp_linear
from ..nn.blocks import stack_apply, stack_cache_shape, stack_init
from ..nn.layers import (block, embed, embed_attend, embed_init, linear,
                         linear_cols, linear_init, norm, norm_init)
from ..nn.module import shapes_only, torch_dtype, tree_map
from ..parallel import collectives as coll
from ..parallel.sharding import layer_params, model_share, splits


def init(seed_or_generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """Random parameters, the reference's scheme (truncated normal, std
    fan_in^-0.5, embedding std 1, zero biases, unit norm scales) drawn from
    a ``torch.Generator`` (an int seed: the host's), then moved to
    ``device``.  A generator on the card draws a full-width model there,
    with other numbers than the host's.  On ``meta`` the leaves are shapes
    and dtypes only: nothing is drawn (the dry run's params)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    dtype = torch_dtype(cfg.param_dtype)
    with shapes_only(dev):
        p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
             "stack": stack_init(gen, cfg),
             "final_norm": norm_init(cfg.norm_type, cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    return to_device(p, dev)


def to_device(tree, device):
    """A params (or cache) tree with every tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)


def _reference_layers(stack, cfg: ArchConfig):
    """The reference's {"prefix": [...], "scan": {"b<j>": stacked}} as a
    list in layer order: group m's block j is layer prefix + m * period +
    j."""
    period = cfg.pattern_period()
    n_groups = (cfg.num_layers - len(stack["prefix"])) // period
    return list(stack["prefix"]) + [
        tree_map(lambda a: a[m], stack["scan"][f"b{j}"])
        for m in range(n_groups) for j in range(period)]


def _stack(trees, device):
    """Trees of one structure -> one tree of their leaves stacked on a new
    leading axis (on ``device``, or each leaf's own)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], device) for k in first}
    return torch.stack([t.detach().to(device or t.device) for t in trees])


def _n_prefix(cfg: ArchConfig) -> int:
    """The dense-prefix layers the reference runs unstacked."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def to_reference_layout(tree, cfg: ArchConfig, *, device=None) -> dict:
    """A params-shaped tree (params, grads, AdamW moments) in the
    reference's layout: the first ``first_k_dense`` layers in "prefix",
    the rest stacked into "scan": {"b<j>": ...}, group m's block j holding
    layer prefix + m * period + j.  The leaves are new tensors on
    ``device`` (the host, for a checkpoint) or on each leaf's own
    device."""
    period = cfg.pattern_period()
    n_prefix = _n_prefix(cfg)
    layers = tree["stack"]
    prefix = [tree_map(lambda t: t.detach().to(device or t.device,
                                               copy=True), layer)
              for layer in layers[:n_prefix]]
    scan = {f"b{j}": _stack(layers[n_prefix + j::period], device)
            for j in range(period)}
    return dict(tree, stack={"prefix": prefix, "scan": scan})


def from_reference_layout(tree, cfg: ArchConfig) -> dict:
    """The inverse of :func:`to_reference_layout`: the layer list of
    views into the stacked leaves (no copy)."""
    return dict(tree, stack=_reference_layers(tree["stack"], cfg))


def quantize_linear_tree(params, cfg: ArchConfig, *,
                         min_size: int = 1 << 16) -> dict:
    """The reference's ``quantize_linear_tree`` of the params in its
    layout (its ``bfp8`` serving weights: blocks of 64, 8 bits, the
    widths ``linear`` and ``weight_of`` dequantize at), on the port's
    layer list: the same leaves quantize, to the same bits.  A layer the
    reference stacks into its scan groups is judged as that stacked leaf
    (``core.bfp.quantizable``'s ``stack``); its blocks run along K either
    way.  Each layer is compressed on its own, so no second copy of the
    model is made.  An encoder-decoder's two layer lists are judged as the
    reference stacks them."""
    n_prefix = _n_prefix(cfg)
    groups = (cfg.num_layers - n_prefix) // cfg.pattern_period()
    # (unstacked prefix layers, scan groups) of each layer list: an
    # encoder-decoder's encoder is one group a layer, its decoder as an LM
    stacks = {"stack": (n_prefix, groups), "dec_stack": (n_prefix, groups),
              "enc_stack": (0, cfg.encoder_layers)}
    out = {k: bfp.quantize_linear_tree(v, min_size=min_size)
           for k, v in params.items() if k not in stacks}
    for k in stacks.keys() & params.keys():
        prefix, n = stacks[k]
        out[k] = [bfp.quantize_linear_tree(
            layer, min_size=min_size, stack=0 if i < prefix else n)
            for i, layer in enumerate(params[k])]
    return out


def _tensors(tree, device):
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_from_reference(np_params, cfg: ArchConfig, *, device="cuda"):
    """Carry the reference's LM parameters (``repro.models.lm.init``'s
    pytree, as numpy arrays) into the port's params on ``device``."""
    p = dict(np_params, stack=_reference_layers(np_params["stack"], cfg))
    return _tensors(p, device)


def cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    """Per-layer cache structure, by each layer's mixer: [{"attn": {"k":
    (shape, dtype), "v": ...}}] (GQA), [{"attn": {"ckv": ..., "kpe":
    ...}}] (MLA) or [{"ssm": {"conv_x": ..., "state": ...}}]."""
    return stack_cache_shape(cfg, batch, max_len)


def cache_init(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero caches for ``batch`` slots (of ``max_len`` positions for the
    attention layers; an SSM layer's is its conv window and state)."""
    return zero_caches(cache_shape(cfg, batch, max_len), device)


def zero_caches(shapes, device):
    """Zero buffers of a per-layer cache structure on ``device``."""
    dev = resolve_device(device)
    return [{kind: {name: torch.zeros(shape, dtype=dt, device=dev)
                    for name, (shape, dt) in bufs.items()}
             for kind, bufs in c.items()}
            for c in shapes]


def vocab_share(cfg: ArchConfig):
    """The ``model`` share the vocabulary is split over, or None."""
    share = model_share()
    return share if share and splits("vocab", cfg.vocab_size) else None


def embed_tokens(params, cfg: ArchConfig, tokens):
    """The tokens' embeddings in ``cfg.dtype``, every rank's whole."""
    return embed(layer_params(params["embed"]), tokens,
                 torch_dtype(cfg.dtype), vocab_share(cfg), cfg.vocab_size)


def _readout(params, cfg: ArchConfig, x):
    x = x.to(torch_dtype(cfg.dtype))
    key = "embed" if cfg.tie_embeddings else "lm_head"
    params = {key: layer_params(params[key])}
    share = vocab_share(cfg)
    if share is not None:
        V = cfg.vocab_size
        if cfg.tie_embeddings:
            return embed_attend(params["embed"], x, share, V)
        if cfg.fc_bfp:
            return bfp_linear(x, block(params["lm_head"]["w"], 1, V,
                                       share).contiguous())
        return linear_cols(params["lm_head"], x, V, share,
                           dtype=torch.float32)
    if cfg.tie_embeddings:
        return embed_attend(params["embed"], x)
    if cfg.fc_bfp:
        # paper §3.6 on the decode engine's FC path: every decode step
        # streams the full (d_model, vocab) head, so move it as
        # shared-exponent int8 BFP through kernel 4
        return bfp_linear(x, params["lm_head"]["w"])
    return linear(params["lm_head"], x, dtype=torch.float32)


def apply(params, cfg: ArchConfig, tokens, *, mode: str = "train",
          length=None, caches=None, collect_aux: bool = False):
    """tokens (B, S) int -> (logits (B, S, V) f32, caches, aux).

    train: no caches.  prefill: ``caches`` (zeroed, one row per sequence)
    filled from position 0.  decode: S new tokens (one, in serving)
    appended at ``length``, a scalar or a (B,) tensor; the caches are
    updated in place.  aux: the MoE layers' router loss, summed, under
    ``collect_aux``; else 0."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    x = embed_tokens(params, cfg, tokens)
    x, new_caches, aux = stack_apply(params["stack"], cfg, x, mode=mode,
                                     length=length, caches=caches,
                                     collect_aux=collect_aux)
    x = norm(cfg.norm_type, layer_params(params["final_norm"]), x)
    return _readout(params, cfg, x), new_caches, aux


def loss_fn(params, cfg: ArchConfig, batch, collect_aux: bool = True):
    """batch: {"inputs": (B,S), "targets": (B,S)} int tensors; targets < 0
    are masked.  Returns (loss + aux, metrics) as the reference does."""
    logits, _, aux = apply(params, cfg, batch["inputs"], mode="train",
                           collect_aux=collect_aux)
    return _ce(logits, batch["targets"], aux, vocab_share(cfg))


def greedy(logits, share=None):
    """The index of each row's max over the last axis, the lowest among
    equal maxima (``argmax``), int32; with ``share`` the rows are the
    rank's block of the vocabulary and the answer is the whole row's."""
    idx = logits.argmax(-1)
    if share is None:
        return idx.to(torch.int32)
    val = logits.gather(-1, idx[..., None])[..., 0].to(torch.float32)
    idx = idx + share.block(logits.shape[-1] * share.size)[0]
    vals = coll.gather_nograd(val[None], 0, share)       # (m, ...)
    idxs = coll.gather_nograd(idx[None], 0, share)
    best = vals.argmax(0)                       # the lowest rank among ties
    return idxs.gather(0, best[None])[0].to(torch.int32)


def _ce(logits, targets, aux, share=None):
    """Masked mean cross entropy over the valid targets, the reference's
    formulation: the log-sum-exp against the detached row max, and the
    label's logit (here gathered: the reference's one-hot select-sum adds
    zeros to it, the same value).  Accuracy counts a label whose logit is
    >= the row max, ties included."""
    if share is not None:
        return _ce_split(logits, targets, aux, share)
    valid = targets >= 0
    tgt = torch.clamp(targets, min=0).long()
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = lse - label_logit
    denom = torch.clamp(valid.sum(), min=1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    total = loss + aux
    is_max = label_logit >= m[..., 0]
    metrics = {"loss": loss, "aux_loss": aux, "tokens": denom,
               "accuracy": (valid & is_max).sum() / denom}
    return total, metrics


def _ce_split(logits, targets, aux, share):
    """:func:`_ce` on the rank's block of the vocabulary's logits: the row
    max (detached) and the sum of exponentials against it across the
    ranks, the label's logit from the rank that holds it; every rank gets
    the same loss and metrics."""
    valid = targets >= 0
    tgt = torch.clamp(targets, min=0).long()
    lf = logits.to(torch.float32)
    Vl = lf.shape[-1]
    lo = share.rank * Vl
    m = coll.all_max(lf.amax(dim=-1), share)
    se = coll.reduce_sum(torch.sum(torch.exp(lf - m[..., None]), dim=-1),
                         share)
    lse = torch.log(se) + m
    mine = (tgt >= lo) & (tgt < lo + Vl)
    ll = torch.gather(lf, -1, (tgt - lo).clamp(0, Vl - 1)[..., None])[..., 0]
    label_logit = coll.reduce_sum(torch.where(mine, ll, 0.0), share)
    nll = lse - label_logit
    denom = torch.clamp(valid.sum(), min=1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    total = loss + aux
    is_max = label_logit >= m
    metrics = {"loss": loss, "aux_loss": aux, "tokens": denom,
               "accuracy": (valid & is_max).sum() / denom}
    return total, metrics
