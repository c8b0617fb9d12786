"""Elementary layers: linear, norms, embeddings, rotary position encoding
(the reference's ``repro/nn/layers.py``).  Parameters are drawn on the
host; the model moves them to its device."""
from __future__ import annotations

import torch

from ..core.bfp import weight_of
from .module import param


# --- linear ----------------------------------------------------------------
def linear_init(gen, d_in: int, d_out: int, dtype, bias: bool = False):
    p = {"w": param(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def linear(p, x, dtype=None):
    """Matmul in the activation dtype: the f32 master weight is cast to
    ``x.dtype`` (or ``dtype``), as in the reference's mixed precision.  A
    BFP-compressed weight (``core.bfp.quantize_linear_tree``'s ``w_q``,
    ``w_e``) is dequantized to f32 first, then cast, as the reference
    does."""
    dt = dtype if dtype is not None else x.dtype
    y = x.to(dt) @ weight_of(p, "w", dtype=dt)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# --- norms -----------------------------------------------------------------
def rmsnorm_init(d: int, dtype):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    y = x * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(dt)


def norm_init(kind: str, d: int, dtype):
    return rmsnorm_init(d, dtype) if kind == "rmsnorm" else \
        layernorm_init(d, dtype)


def norm(kind: str, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# --- embedding ---------------------------------------------------------------
def embed_init(gen, vocab: int, d: int, dtype):
    return {"embedding": param(gen, (vocab, d), dtype, scale=1.0)}


def embed(p, tokens, dtype):
    # gather, then cast: the same values as casting the whole table first
    return p["embedding"][tokens.long()].to(dtype)


def embed_attend(p, x):
    """Tied readout: logits in f32 (softmax stability)."""
    return x.to(torch.float32) @ p["embedding"].to(torch.float32).T


# --- rotary ------------------------------------------------------------------
def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding on half-split halves, with f32 angles.

    x: (..., seq, heads, head_dim) or (..., seq, head_dim); positions
    broadcastable to (..., seq)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freq
    if x.ndim == angles.ndim + 1:       # insert the heads axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
