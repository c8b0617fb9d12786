"""Mixture-of-experts FFN with GShard-style one-hot dispatch (the
reference's ``repro/nn/moe.py``).

Tokens are grouped along the sequence, ``sg = min(group_size, S)`` a
group, the sequence zero-padded to a multiple of ``sg``; pad rows are
routed and take up capacity like real tokens, and are sliced off at the
end.  The router runs in f32; each token's top-k experts are taken in
order of probability, ties to the lower expert index (as
``jax.lax.top_k``: a stable sort, not ``torch.topk``, whose tie order
differs), and their gates renormalised.  Expert capacity is
``moe_capacity``; slots are given in k-major order (every top-1 choice of
a group before any top-2 choice), and a choice past capacity is dropped
(its token keeps only the residual path and the shared experts).

The dispatch and combine tensors (G, sg, E, C) and the expert products
over (E, G, C, D) are the reference's einsums: every expert's weights
are read whatever the routing, and the result is deterministic.  There
is no kernel on this path in the reference, and none here.

:func:`moe_apply_tp` splits the experts over ``model`` where the rules
split ``experts``: the router and the top-k stay replicated (every rank
routes every token alike, ties included), the rank runs its experts'
slots of dispatch and combine, and its output is its partial sum over
them (summed by the caller's collective, in the ring's fixed order; no
float atomics).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig, MoECfg
from ..parallel.sharding import batch_mean, splits
from .layers import linear, linear_init, weight_block
from .mlp import mlp_apply, mlp_apply_tp, mlp_init
from .module import param, torch_dtype


def moe_init(gen, cfg: ArchConfig):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    dtype = torch_dtype(cfg.param_dtype)
    p = {"router": linear_init(gen, d, E, dtype),
         "experts": {"w1": param(gen, (E, d, f), dtype),
                     "w3": param(gen, (E, d, f), dtype),
                     "w2": param(gen, (E, f, d), dtype)}}
    if m.num_shared:
        p["shared"] = mlp_init(gen, cfg, d_ff=m.d_ff * m.num_shared)
    return p


def moe_capacity(m: MoECfg, sg: int) -> int:
    return max(1, int(sg * m.top_k / m.num_experts * m.capacity_factor))


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, cfg: ArchConfig, xg):
    """Routing of the groups ``xg`` (G, sg, D) -> (probs (G, sg, E) f32,
    gates (G, sg, k) in xg's dtype, expert indices (G, sg, k))."""
    probs = torch.softmax(linear(p["router"], xg, dtype=torch.float32),
                          dim=-1)
    gates, idx = top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates.to(xg.dtype), idx


def group(cfg: ArchConfig, x):
    """x (B, S, D) zero-padded and grouped -> (xg (G, sg, D), pad)."""
    B, S, D = x.shape
    sg = min(cfg.moe.group_size, S)
    pad = (-S) % sg
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    return xp.reshape(-1, sg, D), pad


def moe_apply(p, cfg: ArchConfig, x, *, return_aux: bool = False):
    """x (B, S, D) -> (y (B, S, D), aux or None)."""
    y, _, aux = moe_apply_tp(p, cfg, x, None, return_aux=return_aux)
    return y, aux


def moe_apply_tp(p, cfg: ArchConfig, x, share, *, return_aux: bool = False):
    """(y, kind, aux) under ``share``: the rank's partial sum over its
    experts (and its block of the shared experts' MLP) where the rules
    split ``experts``; else the experts on every rank, kind "full" where
    the shared MLP is whole too.  ``share`` None: :func:`moe_apply`."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    xg, pad = group(cfg, x)
    G, sg = xg.shape[:2]
    probs, gates, idx = route(p, cfg, xg)

    # capacity slots in k-major order: every top-1 choice of a group comes
    # before any top-2 choice
    C = moe_capacity(m, sg)
    sel = F.one_hot(idx, E)                                    # (G,s,k,E)
    flat = sel.transpose(1, 2).reshape(G, k * sg, E)
    pos = (flat.cumsum(1) - flat).reshape(G, k, sg, E).transpose(1, 2)
    # a token picks an expert at most once, so each (token, expert) has
    # one slot and one gate; a slot >= C matches no column (dropped)
    slot = (pos * sel).sum(2)                                  # (G,s,E)
    chosen = sel.sum(2).bool()
    dispatch = ((slot[..., None] == torch.arange(C, device=x.device))
                & chosen[..., None]).to(x.dtype)               # (G,s,E,C)
    combine = (gates[..., None] * sel.to(x.dtype)).sum(2)[..., None] \
        * dispatch

    w = p["experts"]
    mine = share is not None and splits("experts", E)
    if mine:        # the rank's experts' slots only
        lo, hi = share.block(E)
        dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
    wts = [weight_block(w, n, 0, E, share if mine else None, x.dtype)
           for n in ("w1", "w3", "w2")]
    xe = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, wts[0]))
    h = h * torch.einsum("egcd,edf->egcf", xe, wts[1])
    ye = torch.einsum("egcf,efd->egcd", h, wts[2])
    y = torch.einsum("gsec,egcd->gsd", combine, ye)
    kind = "partial" if mine else "full"
    if "shared" in p:
        if share is None:
            y = y + mlp_apply(p["shared"], cfg, xg)
        else:
            ys, skind = mlp_apply_tp(p["shared"], cfg, xg, share,
                                     d_ff=m.d_ff * m.num_shared)
            if skind != kind:   # a whole term held once: on rank 0
                if kind == "full":
                    y = y if share.rank == 0 else torch.zeros_like(y)
                else:
                    ys = ys if share.rank == 0 else torch.zeros_like(ys)
                kind = "partial"
            y = y + ys
    y = y.reshape(B, S + pad, D)[:, :S].to(x.dtype)
    if not return_aux:
        return y, kind, None
    # load-balance loss (Switch/GShard): E * sum_e f_e * p_e, over the pad
    # rows too, as the reference averages; both means span the global batch
    # under a data-parallel mesh step
    me = batch_mean(probs.mean(dim=(0, 1)))
    ce = batch_mean(sel.to(torch.float32).sum(2).mean(dim=(0, 1))) / k
    return y, kind, E * torch.sum(me * ce) * m.router_aux_coef
