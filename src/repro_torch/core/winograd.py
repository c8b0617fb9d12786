"""General Cook–Toom Winograd transforms F(m, r), the pure-torch
F(m, 3) x F(m, 3) convolution (the port's ``winograd`` route) and the
pure-torch F(m, r) depthwise causal 1-D convolution (Mamba-2's conv, F(3,
4) at its 4 taps).

``WinogradTransform``/``winograd_transform`` are numpy and identical to the
reference (``repro/core/winograd.py``), so both packages use the same
transform matrices.  ``auto_c_block``/``auto_pool_rows`` are the reference's
block-sizing rules; the port keeps them only so its packed weight slabs have
the reference's shapes (the CUDA kernels do not use the TPU budgets).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

# good default point sets (wincnn-style), indexed by number of finite points
_POINTS = [0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 3.0, -3.0, 1.5, -1.5]


@dataclass(frozen=True)
class WinogradTransform:
    m: int                 # outputs per tile
    r: int                 # filter taps
    AT: np.ndarray         # (m, n)
    G: np.ndarray          # (n, r)
    BT: np.ndarray         # (n, n)

    @property
    def n(self) -> int:
        return self.m + self.r - 1

    @property
    def mult_ratio(self) -> float:
        """direct multiplies / winograd multiplies per 1D tile."""
        return (self.m * self.r) / self.n


def _vandermonde(points, k: int) -> np.ndarray:
    """(len(points)+1, k): rows eval poly of deg k-1 at points; last row = ∞
    (leading-coefficient selector)."""
    rows = [[p ** j for j in range(k)] for p in points]
    rows.append([0.0] * (k - 1) + [1.0])
    return np.asarray(rows, dtype=np.float64)


@lru_cache(maxsize=None)
def winograd_transform(m: int, r: int) -> WinogradTransform:
    n = m + r - 1
    assert 2 <= m and 2 <= r and n - 1 <= len(_POINTS), (m, r)
    pts = _POINTS[: n - 1]
    G = _vandermonde(pts, r)                    # (n, r)
    AT = _vandermonde(pts, m).T                 # (m, n)

    # Solve for B^T from the bilinear identity (exact; verified below).
    # M[(j,k), t] = AT[j,t] * G[t,k]; target T[(j,k), i] = [i == j+k]
    M = np.einsum("jt,tk->jkt", AT, G).reshape(m * r, n)
    T = np.zeros((m, r, n))
    for j in range(m):
        for k in range(r):
            T[j, k, j + k] = 1.0
    T = T.reshape(m * r, n)
    BT, res, rank, _ = np.linalg.lstsq(M, T, rcond=None)
    # verify the algorithm end-to-end on random data
    rng = np.random.default_rng(0)
    g = rng.standard_normal((r,))
    d = rng.standard_normal((n,))
    o = AT @ ((G @ g) * (BT @ d))
    o_ref = np.array([np.dot(g, d[j:j + r]) for j in range(m)])
    err = np.abs(o - o_ref).max() / max(np.abs(o_ref).max(), 1e-9)
    assert err < 1e-8, f"F({m},{r}) construction failed: rel err {err}"
    return WinogradTransform(m, r, AT, G, BT)


def transform_tensors(m: int, r: int, device) -> tuple:
    """(BT, G, AT) of F(m, r) as float32 tensors on ``device``, copied
    there once per process (a copy to the card waits for the stream).
    Callers only read them."""
    return _transform_tensors(m, r, str(torch.device(device)))


@lru_cache(maxsize=None)
def _transform_tensors(m: int, r: int, device: str) -> tuple:
    t = winograd_transform(m, r)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (t.BT, t.G, t.AT))


def tiles_1d(x, m: int, n: int, r: int):
    """x (B, L, C) -> causal overlapping tiles (B, nt, n, C), nt =
    ceil(L/m): left pad r - 1, right pad to nt * m + r - 1 rows."""
    L = x.shape[1]
    nt = -(-L // m)
    xp = torch.nn.functional.pad(x, (0, 0, r - 1, nt * m - L))
    return xp.unfold(1, n, m).permute(0, 1, 3, 2)


def conv1d_depthwise_causal(x, w, b=None, m: int | None = None):
    """Winograd depthwise causal conv by F(m, r) in x's dtype (the
    reference's pure-jnp twin of its kernel).  x (B,L,C); w (r,C); returns
    (B,L,C); ``m`` defaults to the reference's {3: 4, 4: 3}.get(r, 2).

    Output o[t, c] = sum_k w[k, c] * x[t - r + 1 + k, c]  (left-padded).
    """
    r = w.shape[0]
    m = m or {3: 4, 4: 3}.get(r, 2)
    t = winograd_transform(m, r)
    B, L, C = x.shape
    tiles = tiles_1d(x, t.m, t.n, r)
    BT, G, AT = (a.to(x.dtype) for a in transform_tensors(m, r, x.device))
    U = torch.einsum("tn,bjnc->bjtc", BT, tiles)
    V = torch.einsum("tr,rc->tc", G, w.to(x.dtype))
    Y = torch.einsum("mt,bjtc->bjmc", AT, U * V[None, None])
    y = Y.reshape(B, -1, C)[:, :L]
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def tiles_2d(x, m: int, n: int):
    """x (B,H,W,C) pre-padded -> (B, th, tw, n, n, C); stride-m windows."""
    t = x.unfold(1, n, m).unfold(2, n, m)       # (B, th, tw, C, n, n)
    return t.permute(0, 1, 2, 4, 5, 3)


def _conv2d_winograd_single(x, w, b, *, m: int, padding: str, relu: bool):
    r = w.shape[0]
    t = winograd_transform(m, r)
    B, H, W, C = x.shape
    K = w.shape[-1]
    if padding == "SAME":
        ph = r // 2
        out_h, out_w = H, W
    else:  # VALID
        ph = 0
        out_h, out_w = H - r + 1, W - r + 1
    th, tw = -(-out_h // t.m), -(-out_w // t.m)
    need_h = th * t.m + r - 1
    need_w = tw * t.m + r - 1
    xp = torch.nn.functional.pad(
        x.float(), (0, 0, ph, need_w - W - ph, ph, need_h - H - ph))
    tiles = tiles_2d(xp, t.m, t.n)              # (B,th,tw,n,n,C)
    BT, G, AT = transform_tensors(m, r, x.device)
    U = torch.einsum("in,bhwnmc,jm->bhwijc", BT, tiles, BT)
    V = torch.einsum("in,nmck,jm->ijck", G, w.float(), G)
    Yw = torch.einsum("bhwijc,ijck->bhwijk", U, V)   # n^2 batched GEMMs
    Y = torch.einsum("pi,bhwijk,qj->bhwpqk", AT, Yw, AT)
    y = Y.permute(0, 1, 3, 2, 4, 5).reshape(B, th * t.m, tw * t.m, K)
    y = y[:, :out_h, :out_w]
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def conv2d_winograd(x, w, b=None, *, m: int = 4, padding: str = "SAME",
                    relu: bool = False, groups: int = 1, lrn=None, pool=None):
    """2D stride-1 convolution via F(m, r)xF(m, r), fused layer epilogue.

    x (B,H,W,C); w (r,r,C//groups,K).  Same contract as the reference's
    ``repro.core.winograd.conv2d_winograd``: optional bias, ReLU, groups,
    then LRN (over the full concatenated channel dim) and VALID max-pool.
    """
    assert w.shape[0] == w.shape[1], "square filters only"
    g = groups
    K = w.shape[-1] // g
    C = x.shape[-1] // g
    ys = [_conv2d_winograd_single(
        x[..., i * C:(i + 1) * C], w[..., i * K:(i + 1) * K],
        None if b is None else b[i * K:(i + 1) * K],
        m=m, padding=padding, relu=relu) for i in range(g)]
    y = ys[0] if g == 1 else torch.cat(ys, dim=-1)
    if lrn is not None or pool is not None:
        from ..nn.pooling import apply_epilogue
        y = apply_epilogue(y, lrn, pool)
    return y


def auto_c_block(hp: int, wp: int, c: int, *, batch: int = 1,
                 dtype_bytes: int = 4,
                 budget_bytes: int = 8 * 2 ** 20) -> int:
    """Channel block of the packed slab: the reference's rule (largest block
    whose (batch, hp, wp, Cb) input block fits its budget), kept so the
    port's slabs have the reference's shapes."""
    per_chan = max(batch * hp * wp * dtype_bytes, 1)
    fit = max(int(budget_bytes // per_chan), 1)
    return c if fit >= c else max(min(fit, 128), 1)


def auto_pool_rows(ph_out: int, pwin: int, ps: int, *, align: int = 1,
                   row_align: int = 1, cols: int, kfull: int, batch: int = 1,
                   dtype_bytes: int = 4,
                   budget_bytes: int = 4 * 2 ** 20) -> int:
    """Pooled-row block of the reference's plan (largest ``align``-multiple
    block whose full-channel epilogue scratch fits its budget)."""
    Pb = align * (-(-max(ph_out, 1) // align))
    while Pb > align:
        rows = -(-(ps * (Pb - 1) + pwin) // row_align) * row_align
        if batch * rows * cols * kfull * dtype_bytes <= budget_bytes:
            break
        Pb -= align
    return Pb
