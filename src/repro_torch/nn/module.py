"""Parameter-init helpers (the reference's ``repro/nn/module.py``).

Parameters are plain nested dicts of tensors.  Every layer is a pair of
functions ``<layer>_init(gen, ...) -> params`` and ``<layer>(params, x,
...)``.  Draws come from an explicit ``torch.Generator`` (the host's, or the
card's for a full-width model); the
numbers differ from the reference's ``jax.random`` draw, so tests carry the
reference's params over instead (``models.lm.params_from_reference``).
There is no ``vmap`` stacking: a layer stack is a list of per-layer dicts.
:func:`tree_map`, :func:`tree_map_with_path`, :func:`tree_leaves`,
:func:`count_params` and
:func:`tree_bytes` walk such trees.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32):
    """2-sigma truncated normal, as the reference's initializers, drawn on
    the generator's device (under :func:`shapes_only`, a meta tensor:
    nothing is drawn)."""
    t = torch.empty(shape, dtype=torch.float32, device=draw_device(gen))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


def shapes_only(device):
    """A context in which an init builds ``meta`` tensors when ``device``
    is ``meta`` (shapes and dtypes only: no number is drawn and nothing is
    allocated, as the reference's ``jax.eval_shape`` of its init); a
    no-op on any other device."""
    return (torch.device("meta") if torch.device(device).type == "meta"
            else nullcontext())


def draw_device(gen: torch.Generator):
    """Where a draw from ``gen`` lands: the generator's device, or
    ``meta`` inside :func:`shapes_only`."""
    return ("meta" if torch.get_default_device().type == "meta"
            else gen.device)


def dense_init_std(fan_in: int) -> float:
    return fan_in ** -0.5


def param(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Default weight init: truncated normal with 1/sqrt(fan_in) std."""
    if scale is None:
        scale = dense_init_std(shape[0] if len(shape) > 1 else shape[-1])
    return truncated_normal(gen, shape, scale, dtype)


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a tree of dicts, lists and
    tuples; ``path`` is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts (keys in sorted order, as the
    reference's pytree flattening) and lists, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
