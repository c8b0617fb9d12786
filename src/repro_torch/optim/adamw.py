"""AdamW with global-norm clipping and a warmup + cosine schedule (the
reference's ``repro/optim/adamw.py``).

The state is a plain dict with the reference's keys: ``step`` (an int32
0-d tensor on the host), ``params``, and the f32 moments ``m`` and ``v``
(trees of the params' shape).  Unlike the reference, which returns a new
state, :func:`adamw_step` updates the state in place under
``torch.no_grad()``, leaf by leaf: at mamba2-2.7b the f32 params, grads,
m and v take 43.6 GB, and a second copy of the state would not fit beside
them on an 80 GB card.  The arithmetic keeps the reference's order: the
clip scale, the bias corrections ``1 - b**t`` in f32, the update in f32,
then ``p - lr * update`` in p's dtype.

A sharded state (``runtime/trainer.py``'s mesh step) holds DTensor params
and moments; its ``grads`` are the averaged gradients, whole (identical
on every rank) or, under tensor-parallel compute, the rank's ``model``
block of each leaf the rules split, and under ``--fsdp`` placements
(params split over "data" too) the rank's own block of each such leaf.
The norm is then the full gradient's (the blocks' sums of squares
summed over the mesh dims that split them, each replicated leaf counted
once), and each rank updates its own block of params, m and v in place
with its block of the gradient: the same arithmetic, element by
element.  The moments may be
placed finer than the params (ZeRO-1, the reference's default for its
dry run: ``sharding.zero1_shardings`` shards them over "data" on a dim
the param leaves whole): m, v and the update are then computed on the
moment's block, and the update, in the param's dtype, is gathered over
"data" to the param's block before it is applied.  Every step is
elementwise and a gather moves bits, so the result is the one of moments
placed like the params.
"""
from __future__ import annotations

import math

import torch

from ..nn.module import tree_leaves, tree_map
from ..parallel.collectives import all_gather
from ..parallel.sharding import is_dtensor, local, shard_of


def init_state(params) -> dict:
    """The state of ``params``; DTensor params get DTensor moments placed
    like them."""
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "m": zeros(), "v": zeros()}


def lr_schedule(step, *, base_lr: float, warmup: int = 100,
                total: int = 10_000, min_ratio: float = 0.1):
    """The learning rate at ``step`` (a 0-d tensor or an int), an f32 0-d
    tensor on the step's device: linear warmup, then a cosine down to
    ``min_ratio`` of ``base_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def global_norm(tree, groups=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.
    ``groups``: for each leaf the process groups of the mesh dims over
    which the ranks hold distinct blocks of it (() for a leaf held whole,
    or alike on those ranks); the blocks' sums of squares are summed over
    them, one sum a set of groups, and each leaf is counted once."""
    if groups is None:
        groups = [()] * len(tree_leaves(tree))
    sums: dict = {}
    for x, gs in zip(tree_leaves(tree), groups):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        sums[gs] = sq if gs not in sums else sums[gs] + sq
    total = sums.pop((), None)
    if sums:
        import torch.distributed as dist
        for gs, sq in sums.items():
            for g in gs:
                dist.all_reduce(sq, group=g)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_step(state, grads, *, lr, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.0,
               clip_norm: float = 1.0):
    """One AdamW step on ``state`` in place; ``grads`` a tree of the
    params' structure (or the list of its leaves), whole tensors also for
    DTensor params.  Returns ``(state, {"grad_norm": ...})`` like the
    reference."""
    gnorm = global_norm(grads, _block_groups(state["params"], grads))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if clip_norm else 1.0
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32)
    # lr, bc1 and bc2 are 0-d host tensors: PyTorch passes them to the
    # leaves' kernels as scalars
    for p, g, m, v in zip(tree_leaves(state["params"]), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        finer = _finer_dims(p, m)
        g = (_narrow(g, finer) if g.shape != p.shape
             else shard_of(g, m)).to(torch.float32) * scale
        p, m, v = local(p), local(m), local(v)
        pm = _narrow(p, finer)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            update = update + weight_decay * pm.to(torch.float32)
        p.sub_(lr * _gather(update.to(p.dtype), finer))
    state["step"] = step
    return state, {"grad_norm": gnorm}


def _block_groups(params, grads) -> list:
    """Per leaf, the process groups over which its gradient is distinct
    blocks: where a gradient is the param's block (tensor-parallel
    compute: its ``model`` block; ``--fsdp``: its block over "data" and
    ``model``), the groups of the mesh dims of more than one rank that
    split the param; () where it is whole."""
    out = []
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        if g.shape == p.shape or not is_dtensor(p):
            out.append(())
            continue
        mesh = p.device_mesh
        out.append(tuple(mesh.get_group(i) for i, (size, pl) in enumerate(
            zip(mesh.shape, p.placements)) if pl.is_shard() and size > 1))
    return out


def _finer_dims(p, m) -> list:
    """[(tensor dim, mesh dim's process group, its size, this rank's
    coordinate)] of each mesh dim that shards moment ``m`` and leaves its
    param ``p`` whole (ZeRO-1: ``sharding.zero1_shardings`` adds "data"),
    in mesh order; [] where they are placed alike."""
    if not is_dtensor(m) or m.placements == getattr(p, "placements", None):
        return []
    mesh = m.device_mesh
    out = []
    for i, (pp, mp) in enumerate(zip(p.placements, m.placements)):
        if mp.is_shard() and not pp.is_shard():
            if mesh.shape[i] > 1:     # a one-rank dim holds it whole
                out.append((mp.dim, mesh.get_group(i), mesh.shape[i],
                            mesh.get_coordinate()[i]))
        elif mp != pp:
            raise ValueError(f"adamw_step: moments placed {m.placements} "
                             f"are not a refinement of the param's "
                             f"{p.placements}")
    return out


def _narrow(t, finer):
    """The moment's block of ``t``, the param's block."""
    for d, _, n, c in finer:
        t = t.narrow(d, c * (t.shape[d] // n), t.shape[d] // n)
    return t


def _gather(t, finer):
    """The param's block from each rank's moment block ``t``: gathered
    over the finer mesh dims, innermost first (bits moved, not summed)."""
    for d, group, n, _ in reversed(finer):
        parts = all_gather(t, group)           # (n,) + t.shape
        t = torch.cat(parts.unbind(0), dim=d)
    return t
