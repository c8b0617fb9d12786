"""Mamba-2 SSD (state-space duality) mixer (the reference's
``repro/nn/ssd.py``).

Prefill and train run the x stream's depthwise causal conv through kernel 7
(``kernels/conv/ops.py::conv1d_depthwise_causal``, whose backward is kernel
7 time-reversed and a reduction kernel).  Prefill runs the chunked SSD scan
through kernel 6 (``kernels/ssd/ops.py::ssd_chunked``); train runs it on
the differentiable pure-torch chunked twin (``pallas=False``), the
reference's own training route: its scan kernel has no VJP.  On CPU tensors
the kernels take their plain versions.  Decode is the single-token
recurrence in plain PyTorch.  As in the reference, z/x/B/C/dt are
separate projections and the conv runs per stream (x, B, C); only the x
stream (width d_inner) takes the Winograd kernel.

Caches are updated in place (``copy_`` into the given tensors), as the
attention caches are, so the engine's batched decode needs no copy back.
One difference from the reference, which is a fault there: after a prompt
shorter than k - 1 tokens the reference's prefill keeps fewer than k - 1
rows of conv state (``raw[:, S - (k - 1):]`` starts at a negative index);
here the state is the last k - 1 raw inputs, left-padded with zeros, the
value the causal conv itself assumes.

:func:`mamba_apply_tp` is the mixer under tensor-parallel compute over
``model``, where the rules split ``ssm_inner`` and ``ssm_heads``: the
in-projections match no rule and stay replicated, and the rank computes
only its columns of them, its channels of x and z and its heads of dt;
kernel 7 runs on those channels with the matching columns of the
replicated ``conv_x`` weight, kernel 6 on its heads with its blocks of
``A_log``/``D``/``dt_bias`` (B and C whole), the gated RMSNorm over
``d_inner`` sums its squares across the ranks, and ``out_proj`` on the
rank's rows gives its partial sum.  The decode caches hold the rank's
channels and heads (``sharding.cache_block``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ArchConfig
from ..kernels.conv import ops as conv_ops
from ..kernels.conv.ref import conv1d_depthwise_causal_ref
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ssd import clip_exp
from ..parallel import collectives as coll
from ..parallel.sharding import cache_block, splits
from .layers import block, linear, linear_cols, linear_init, linear_rows, \
    rmsnorm
from .module import draw_device, torch_dtype


# --------------------------------------------------------------------------
# depthwise causal conv1d (k taps)
# --------------------------------------------------------------------------
def causal_conv1d(w, b, x, use_winograd: bool = False):
    """x (B, L, ch); w (k, ch); left-padded causal depthwise conv.

    ``use_winograd`` routes through kernel 7's entry (F(m, k) Winograd at
    the reference's m for k taps, f32 inside); otherwise the
    shift-multiply sum in x's dtype."""
    if use_winograd:
        return conv_ops.conv1d_depthwise_causal(x, w, b)
    return conv1d_depthwise_causal_ref(x, w, b)


def conv_decode_step(w, b, conv_state, xnew):
    """conv_state (B, k-1, ch); xnew (B, 1, ch) -> (y (B,1,ch), new_state)."""
    win = torch.cat([conv_state, xnew], dim=1)               # (B, k, ch)
    y = torch.einsum("bkc,kc->bc", win, w.to(xnew.dtype))[:, None, :]
    y = y + b.to(xnew.dtype)
    return y, win[:, 1:, :]


def conv_tail(raw, k: int):
    """The conv state a prompt leaves: its last k - 1 raw inputs, with
    zeros in front when it is shorter."""
    return F.pad(raw, (0, 0, k - 1, 0))[:, -(k - 1):]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def mamba_init(gen, cfg: ArchConfig):
    s = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    H, G, N, k = cfg.ssm_heads, s.ngroups, s.d_state, s.conv_kernel
    dtype = torch_dtype(cfg.param_dtype)

    def conv(ch):
        w = torch.randn((k, ch), generator=gen, device=draw_device(gen)) * 0.1
        return {"w": w.to(dtype), "b": torch.zeros((ch,), dtype=dtype)}

    # A in [1, 16): standard mamba2 init; dt bias st softplus(dt_bias)~[1e-3,1e-1]
    a = np.linspace(1.0, 16.0, H)
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    return {
        "wz": linear_init(gen, d, di, dtype),
        "wx": linear_init(gen, d, di, dtype),
        "wb": linear_init(gen, d, G * N, dtype),
        "wc": linear_init(gen, d, G * N, dtype),
        "wdt": linear_init(gen, d, H, dtype),
        "conv_x": conv(di),
        "conv_b": conv(G * N),
        "conv_c": conv(G * N),
        "A_log": torch.as_tensor(np.log(a), dtype=dtype),
        "D": torch.ones((H,), dtype=dtype),
        "dt_bias": torch.as_tensor(np.log(np.expm1(dt0)), dtype=dtype),
        "norm": {"scale": torch.ones((di,), dtype=dtype)},
        "out_proj": linear_init(gen, di, d, dtype),
    }


def ssm_cache_shape(cfg: ArchConfig, batch: int):
    """Cache structure of one SSM layer: {name: (shape, dtype)}."""
    s = cfg.ssm
    dt = torch_dtype(cfg.dtype)
    G, N, k1 = s.ngroups, s.d_state, s.conv_kernel - 1
    return {
        "conv_x": ((batch, k1, cfg.d_inner), dt),
        "conv_b": ((batch, k1, G * N), dt),
        "conv_c": ((batch, k1, G * N), dt),
        "state": ((batch, cfg.ssm_heads, N, s.head_dim), torch.float32),
    }


# --------------------------------------------------------------------------
# chunked SSD core, the reference's pure-jnp twin of its kernel
# --------------------------------------------------------------------------
def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative;
    B_, C_ (B,L,G,N).  Returns (y (B,L,H,P), final_state (B,H,N,P)).

    The reference's chunked algorithm with its roundings to x's dtype
    (dt * x and the decay-weighted C.B^T before the intra-chunk product);
    its associative scan over chunks is a loop here, the same recurrence.
    """
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Hg = H // G
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // Q

    xg = x.reshape(Bb, nc, Q, G, Hg, P)
    dtg = dt.reshape(Bb, nc, Q, G, Hg)
    Bg = B_.reshape(Bb, nc, Q, G, N).float()
    Cg = C_.reshape(Bb, nc, Q, G, N).float()
    dtA = (dtg * A.reshape(G, Hg)).float()                      # (B,nc,Q,G,Hg)
    cums = torch.cumsum(dtA, dim=2)                              # inclusive

    # intra-chunk (quadratic)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cg, Bg)              # (B,nc,G,Q,Q)
    t = cums.permute(0, 1, 3, 4, 2)                              # (B,nc,G,Hg,Q)
    Ld = clip_exp(t[..., :, None] - t[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Ld = torch.where(causal, Ld, 0.0)
    dtx = (dtg[..., None] * xg).to(x.dtype)                      # (B,nc,Q,G,Hg,P)
    M = CB[:, :, :, None, :, :] * Ld                             # (B,nc,G,Hg,Q,K)
    y1 = torch.einsum("bcghqk,bckghp->bcqghp", M.to(x.dtype).float(),
                      dtx.float())

    # chunk states
    dte = clip_exp(cums[:, :, -1:] - cums)
    states = torch.einsum("bckgn,bckgh,bckghp->bcghnp", Bg,
                          (dte * dtg).float(), xg.float())       # (B,nc,G,Hg,N,P)

    # inter-chunk recurrence: h_c = h_{c-1} * lam_c + states_c
    lam = clip_exp(cums[:, :, -1])                              # (B,nc,G,Hg)
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * lam[:, c, ..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,G,Hg,N,P)

    y2 = torch.einsum("bcqgn,bcghnp,bcqgh->bcqghp", Cg, h_prev,
                      clip_exp(cums))

    y = (y1 + y2).reshape(Bb, nc * Q, H, P)[:, :L]
    return y.to(x.dtype), h.reshape(Bb, H, N, P)


def ssd_decode_step(x, dt, A, B_, C_, state):
    """One-token recurrence. x (B,1,H,P); dt (B,1,H); B_,C_ (B,1,G,N);
    state (B,H,N,P) f32."""
    H = x.shape[2]
    Hg = H // B_.shape[2]
    dA = torch.exp((dt[:, 0] * A).float())                      # (B,H)
    dtx = (dt[..., None] * x)[:, 0].float()                      # (B,H,P)
    Bh = B_[:, 0].float().repeat_interleave(Hg, dim=1)           # (B,H,N)
    new_state = state * dA[..., None, None] + \
        torch.einsum("bhn,bhp->bhnp", Bh, dtx)
    Ch = C_[:, 0].float().repeat_interleave(Hg, dim=1)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y[:, None].to(x.dtype), new_state


# --------------------------------------------------------------------------
# full mixer
# --------------------------------------------------------------------------
def mamba_apply(p, cfg: ArchConfig, x, *, mode: str, cache=None):
    """x (B, S, d_model) -> (y, cache).  train: no cache.  prefill: the
    given zeroed cache is filled.  decode: S = 1 token per row, the cache
    advanced in place."""
    s = cfg.ssm
    Bb, S, _ = x.shape
    H, P, G, N = cfg.ssm_heads, s.head_dim, s.ngroups, s.d_state

    z = linear(p["wz"], x)
    xs = linear(p["wx"], x)
    bs = linear(p["wb"], x)
    cs = linear(p["wc"], x)
    dt = linear(p["wdt"], x)

    if mode == "decode":
        xs, conv_x = conv_decode_step(p["conv_x"]["w"], p["conv_x"]["b"],
                                      cache["conv_x"], xs)
        bs, conv_b = conv_decode_step(p["conv_b"]["w"], p["conv_b"]["b"],
                                      cache["conv_b"], bs)
        cs, conv_c = conv_decode_step(p["conv_c"]["w"], p["conv_c"]["b"],
                                      cache["conv_c"], cs)
    else:
        raw = {"conv_x": xs, "conv_b": bs, "conv_c": cs}
        xs = causal_conv1d(p["conv_x"]["w"], p["conv_x"]["b"], xs,
                           use_winograd=True)
        bs = causal_conv1d(p["conv_b"]["w"], p["conv_b"]["b"], bs)
        cs = causal_conv1d(p["conv_c"]["w"], p["conv_c"]["b"], cs)
    xs, bs, cs = F.silu(xs), F.silu(bs), F.silu(cs)

    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xs.reshape(Bb, S, H, P)
    bg = bs.reshape(Bb, S, G, N)
    cg = cs.reshape(Bb, S, G, N)

    if mode == "decode":
        y, state = ssd_decode_step(xh, dt, A, bg, cg, cache["state"])
        for name, val in (("conv_x", conv_x), ("conv_b", conv_b),
                          ("conv_c", conv_c), ("state", state)):
            cache[name].copy_(val)
    elif mode == "train":       # the route is fixed by mode: the twin
        y, state = ssd_ops.ssd_chunked(xh, dt, A, bg, cg, chunk=s.chunk,
                                       pallas=False)
    else:
        y, state = ssd_ops.ssd_chunked(xh, dt, A, bg, cg, chunk=s.chunk)
        if mode == "prefill" and cache is not None:
            for name, val in raw.items():
                cache[name].copy_(conv_tail(val, s.conv_kernel))
            cache["state"].copy_(state)

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bb, S, cfg.d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return linear(p["out_proj"], y).to(x.dtype), cache


def _head_groups(t, H: int, lo: int, hi: int):
    """The groups of B or C (B, S, G, N) that heads [lo, hi) read."""
    G = t.shape[2]
    Hg = H // G
    if G == 1:
        return t
    if (hi - lo) % Hg == 0:
        return t[:, :, lo // Hg:hi // Hg]
    if Hg % (hi - lo) == 0:
        return t[:, :, lo // Hg:lo // Hg + 1]
    raise NotImplementedError(f"heads [{lo}, {hi}) across groups of {Hg}")


def mamba_apply_tp(p, cfg: ArchConfig, x, share, *, mode: str, cache=None):
    """(y, kind, cache) under ``share``: kind "partial" where the rules
    split ``ssm_inner`` and ``ssm_heads`` (the rank's channels and heads),
    else :func:`mamba_apply` on every rank ("full")."""
    s = cfg.ssm
    Bb, S, _ = x.shape
    H, P, di = cfg.ssm_heads, s.head_dim, cfg.d_inner
    loc = None if cache is None else {
        n: cache_block(t, n, share)[0] for n, t in cache.items()}
    if not (splits("ssm_inner", di) and splits("ssm_heads", H)):
        y, _ = mamba_apply(p, cfg, x, mode=mode, cache=loc)
        return y, "full", cache
    lo, hi = share.block(H)

    z = linear_cols(p["wz"], x, di, share)
    xs = linear_cols(p["wx"], x, di, share)
    bs = linear(p["wb"], x)
    cs = linear(p["wc"], x)
    dt = linear_cols(p["wdt"], x, H, share)
    wx = block(p["conv_x"]["w"], 1, di, share).contiguous()
    bx = block(p["conv_x"]["b"], 0, di, share)

    if mode == "decode":
        xs, conv_x = conv_decode_step(wx, bx, loc["conv_x"], xs)
        bs, conv_b = conv_decode_step(p["conv_b"]["w"], p["conv_b"]["b"],
                                      loc["conv_b"], bs)
        cs, conv_c = conv_decode_step(p["conv_c"]["w"], p["conv_c"]["b"],
                                      loc["conv_c"], cs)
    else:
        raw = {"conv_x": xs, "conv_b": bs, "conv_c": cs}
        xs = causal_conv1d(wx, bx, xs, use_winograd=True)
        bs = causal_conv1d(p["conv_b"]["w"], p["conv_b"]["b"], bs)
        cs = causal_conv1d(p["conv_c"]["w"], p["conv_c"]["b"], cs)
    xs, bs, cs = F.silu(xs), F.silu(bs), F.silu(cs)

    A = -torch.exp(block(p["A_log"], 0, H, share).float())
    dt = F.softplus(dt.float() + block(p["dt_bias"], 0, H, share).float())
    xh = xs.reshape(Bb, S, hi - lo, P)
    bg = _head_groups(bs.reshape(Bb, S, s.ngroups, s.d_state), H, lo, hi)
    cg = _head_groups(cs.reshape(Bb, S, s.ngroups, s.d_state), H, lo, hi)

    if mode == "decode":
        y, state = ssd_decode_step(xh, dt, A, bg, cg, loc["state"])
        for name, val in (("conv_x", conv_x), ("conv_b", conv_b),
                          ("conv_c", conv_c), ("state", state)):
            loc[name].copy_(val)
    elif mode == "train":
        y, state = ssd_ops.ssd_chunked(xh, dt, A, bg, cg, chunk=s.chunk,
                                       pallas=False)
    else:
        y, state = ssd_ops.ssd_chunked(xh, dt, A, bg, cg, chunk=s.chunk)
        if mode == "prefill" and loc is not None:
            for name, val in raw.items():
                loc[name].copy_(conv_tail(val, s.conv_kernel))
            loc["state"].copy_(state)

    y = y + block(p["D"], 0, H, share).to(y.dtype)[None, None, :, None] * xh
    y = (y.reshape(Bb, S, -1) * F.silu(z))
    # the gated RMSNorm over all of d_inner: the ranks' means of squares,
    # each weighted by its share of the width, summed
    dtype = y.dtype
    yf = y.to(torch.float32)
    var = coll.reduce_sum(yf.square().mean(dim=-1, keepdim=True)
                          * (yf.shape[-1] / di), share)
    y = (yf * torch.rsqrt(var + 1e-6)
         * block(p["norm"]["scale"], 0, di, share).to(torch.float32))
    y = linear_rows(p["out_proj"], y.to(dtype), di, share)
    return y.to(x.dtype), "partial", cache
