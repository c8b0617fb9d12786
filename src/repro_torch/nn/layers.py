"""Elementary layers: linear, norms, embeddings, rotary position encoding
(the reference's ``repro/nn/layers.py``).  Parameters are drawn on the
host; the model moves them to its device.

Under tensor-parallel compute over ``model`` (``share``, a
``parallel.sharding.ModelShare``) a layer holds the rank's block of each
leaf the rules split and the whole of any other: :func:`block` gives the
block a computation needs either way, :func:`linear_cols` multiplies by a
column block (its output the rank's block of the features),
:func:`linear_rows` by a row block (its output the rank's partial sum,
which the caller reduces), and :func:`embed` / :func:`embed_attend` take
the rank's vocabulary rows.  A BFP-compressed leaf (``w_q``, ``w_e``) is
dequantized as it is held, then cut the same way.
"""
from __future__ import annotations

import torch

from ..core.bfp import weight_of
from ..parallel import collectives as coll
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


def block(w, dim: int, n: int, share, *, whole: bool = False):
    """The rank's block along ``dim`` of a leaf whose whole size there is
    ``n``: the leaf itself where it is held as that block, else cut from
    the whole.  ``whole``: the whole, gathered (autograd-aware) where the
    leaf is a block (the attention weights of the sequence-parallel
    regime, the one place a weight moves).  ``w`` as it is without a
    share."""
    if share is None:
        return w
    size = w.shape[dim]
    if whole:
        return w if size == n else coll.gather(w, dim, share)
    lo, hi = share.block(n)
    if size == n:
        return w if hi - lo == n else w.narrow(dim, lo, hi - lo)
    if size != hi - lo:
        raise ValueError(f"a leaf of {size} along dim {dim} is neither the "
                         f"whole {n} nor a block of {share.size}")
    return w


def weight_block(p, key: str, dim: int, n: int, share, dtype=None):
    """:func:`block` of the weight ``p[key]`` along ``dim`` (of the
    weight's dims), raw or BFP-compressed: a compressed leaf held whole
    is cut before it is dequantized (its int8 blocks and exponents; rows
    where the block is whole blocks of K), so a rank dequantizes only its
    block."""
    if key + "_q" not in p or share is None:
        return block(weight_of(p, key, dtype=dtype), dim, n, share)
    q, e = p[key + "_q"], p[key + "_e"]
    nd = q.ndim - 1                       # the weight's dims
    d, k = dim % nd, nd - 2               # k: the blocked axis (K)
    lo, hi = share.block(n)
    if d == k:
        bs = q.shape[-2]
        if q.shape[k] * bs == n and lo % bs == 0 and hi % bs == 0:
            q = q.narrow(k, lo // bs, (hi - lo) // bs)
            e = e.narrow(k, lo // bs, (hi - lo) // bs)
        elif q.shape[k] * bs == n:
            return block(weight_of(p, key, dtype=dtype), dim, n, share)
    elif q.shape[d if d < k else d + 1] == n:
        q = q.narrow(d if d < k else d + 1, lo, hi - lo)
        e = e.narrow(d, lo, hi - lo)
    return weight_of({key + "_q": q, key + "_e": e}, key, dtype=dtype)


def linear_cols(p, x, n_out: int, share, dtype=None):
    """``x`` times the rank's block of the ``n_out`` output columns (and
    its block of the bias): the rank's block of the output features."""
    dt = dtype if dtype is not None else x.dtype
    y = x.to(dt) @ weight_block(p, "w", 1, n_out, share, dt)
    if "b" in p:
        y = y + block(p["b"], 0, n_out, share).to(y.dtype)
    return y


def linear_rows(p, x, n_in: int, share, dtype=None):
    """``x``, the rank's block of the ``n_in`` input features, times the
    rank's block of rows: its partial sum of the output (the bias on rank
    0 alone, so that the sum holds it once)."""
    dt = dtype if dtype is not None else x.dtype
    y = x.to(dt) @ weight_block(p, "w", 0, n_in, share, dt)
    if "b" in p and share.rank == 0:
        y = y + p["b"].to(y.dtype)
    return y


def linear_whole(p, x, n_in: int, n_out: int, share, dtype=None):
    """``x`` times the whole weight, gathered where the rank holds a block
    of it (:func:`block` with ``whole``)."""
    dt = dtype if dtype is not None else x.dtype
    w = weight_of(p, "w", dtype=dt)
    for dim, n in ((0, n_in), (1, n_out)):
        w = block(w, dim, n, share, whole=True)
    y = x.to(dt) @ w
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


def embed(p, tokens, dtype, share=None, vocab: int = 0):
    """The tokens' rows.  With ``share`` (the vocabulary split over
    ``model``) each rank looks up the tokens in its rows, zero elsewhere,
    and the ranks' rows are summed: every rank holds the whole."""
    if share is None:
        # gather, then cast: the same values as casting the whole table
        # first
        return p["embedding"][tokens.long()].to(dtype)
    lo, hi = share.block(vocab)
    t = tokens.long()
    mine = (t >= lo) & (t < hi)
    rows = block(p["embedding"], 0, vocab, share)
    x = rows[(t - lo).clamp(0, hi - lo - 1)].to(dtype)
    return coll.reduce_sum(torch.where(mine[..., None], x, 0.0), share)


def embed_attend(p, x, share=None, vocab: int = 0):
    """Tied readout: logits in f32 (softmax stability); with ``share`` the
    rank's block of the vocabulary's."""
    w = block(p["embedding"], 0, vocab, share)
    return x.to(torch.float32) @ w.to(torch.float32).T


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
