"""Parameter-init helpers (the reference's ``repro/nn/module.py``).

Parameters are plain nested dicts of tensors.  Every layer is a pair of
functions ``<layer>_init(gen, ...) -> params`` and ``<layer>(params, x,
...)``.  Draws come from an explicit ``torch.Generator`` (the host's, or the
card's for a full-width model); the
numbers differ from the reference's ``jax.random`` draw, so tests carry the
reference's params over instead (``models.lm.params_from_reference``).
There is no ``vmap`` stacking: a layer stack is a list of per-layer dicts.
"""
from __future__ import annotations

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
    the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


def dense_init_std(fan_in: int) -> float:
    return fan_in ** -0.5


def param(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Default weight init: truncated normal with 1/sqrt(fan_in) std."""
    if scale is None:
        scale = dense_init_std(shape[0] if len(shape) > 1 else shape[-1])
    return truncated_normal(gen, shape, scale, dtype)
