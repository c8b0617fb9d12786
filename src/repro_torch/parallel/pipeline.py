"""GPipe-style pipeline parallelism (the reference's
``repro/parallel/pipeline.py``), over a mesh dim's process group.

Schedule: plain GPipe fill-drain over T = M + S - 1 ticks (M microbatches,
S stages): at tick t stage s runs microbatch t - s, then sends its output
to stage s + 1 (``dist.batch_isend_irecv`` on the ``pipe`` dim's group).
Stage 0 reads the microbatches; the last stage records the finished ones
and broadcasts them to its group.  Bubble fraction = (S-1)/(M+S-1),
reported by :func:`bubble_fraction`.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..nn.module import tree_map
from .sharding import is_dtensor


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(fn: Callable, stage_params, x, *, mesh,
                   axis: str = "pipe", n_micro: int | None = None):
    """Run ``y = fn(params_s, x)`` through S stages over microbatches.

    stage_params: tree with leading stage axis S (whole on every rank, or
    DTensors sharded over ``axis``: each rank uses its own stage's slice).
    x: (M, mb, ...) microbatched input, alike on every rank.  fn must
    preserve the activation shape (residual-block stacks do).  Returns
    (M, mb, ...) on every rank of the group.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    M = x.shape[0] if n_micro is None else n_micro
    T = M + S - 1
    params = tree_map(lambda a: a.to_local()[0] if is_dtensor(a) else a[sid],
                      stage_params)
    nxt = dist.get_global_rank(group, sid + 1) if sid < S - 1 else None
    prv = dist.get_global_rank(group, sid - 1) if sid > 0 else None

    outs = torch.zeros_like(x)
    buf = torch.zeros_like(x[0])               # the activation in transit
    for t in range(T):
        inp = x[min(t, M - 1)] if sid == 0 else buf
        out = fn(params, inp)
        # stage s processes microbatch t-s at tick t; valid window check
        if not 0 <= t - sid < M:
            out = torch.zeros_like(out)
        # last stage records its finished microbatch
        if sid == S - 1 and t - (S - 1) >= 0:
            outs[t - (S - 1)] = out
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), nxt, group))
        if prv is not None:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # only the last stage holds real outputs; broadcast them to all
    dist.broadcast(outs, src=dist.get_global_rank(group, S - 1), group=group)
    return outs
