"""Feed-forward sublayers: SwiGLU and GELU MLP (the reference's
``repro/nn/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..config import ArchConfig
from .layers import linear, linear_init
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
