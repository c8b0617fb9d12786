"""Feed-forward sublayers: SwiGLU and GELU MLP (the reference's
``repro/nn/mlp.py``).  :func:`mlp_apply_tp` is the tensor-parallel form:
``w1``/``w3`` on the rank's block of the ``mlp`` columns, ``w2`` on its
rows, the output the rank's partial sum."""
from __future__ import annotations

import torch.nn.functional as F

from ..config import ArchConfig
from ..parallel.sharding import splits
from .layers import linear, linear_cols, linear_init, linear_rows
from .module import torch_dtype


def mlp_init(gen, cfg: ArchConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dtype = torch_dtype(cfg.param_dtype)
    if cfg.mlp_type == "swiglu":
        return {"w1": linear_init(gen, d, f, dtype),
                "w3": linear_init(gen, d, f, dtype),
                "w2": linear_init(gen, f, d, dtype)}
    return {"w1": linear_init(gen, d, f, dtype, bias=cfg.qkv_bias),
            "w2": linear_init(gen, f, d, dtype, bias=cfg.qkv_bias)}


def mlp_apply(p, cfg: ArchConfig, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(p["w1"], x)) * linear(p["w3"], x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(p["w1"], x), approximate="tanh")
    return linear(p["w2"], h).to(x.dtype)


def mlp_apply_tp(p, cfg: ArchConfig, x, share, d_ff: int | None = None):
    """(y, kind) under ``share``: kind "partial" (the rank's partial sum
    over its block of the ``d_ff`` hidden units) where the rules split
    ``mlp``, else "full" (:func:`mlp_apply` on every rank)."""
    n = d_ff or cfg.d_ff
    if not splits("mlp", n):
        return mlp_apply(p, cfg, x), "full"
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear_cols(p["w1"], x, n, share)) \
            * linear_cols(p["w3"], x, n, share)
    else:
        h = F.gelu(linear_cols(p["w1"], x, n, share), approximate="tanh")
    return linear_rows(p["w2"], h, n, share).to(x.dtype), "partial"
