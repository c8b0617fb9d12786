"""General Cook–Toom Winograd transforms F(m, r), the pure-torch
F(m, 3) x F(m, 3) convolution (the port's ``winograd`` route) and the
pure-torch F(m, r) depthwise causal 1-D convolution (Mamba-2's conv, F(3,
4) at its 4 taps).

``WinogradTransform``/``winograd_transform`` are numpy and identical to the
reference (``repro/core/winograd.py``), so both packages use the same
transform matrices.  ``auto_c_block``/``auto_pool_rows`` are the reference's
block-sizing rules; the port keeps them so its packed weight slabs have
the reference's shapes (the CUDA kernels do not use the TPU budgets), and
so ``conv2d_hbm_bytes`` / ``conv_flops``, the reference's per-layer traffic
and work model, give its numbers (``core/roofline.py`` turns them into
time on the card).  ``conv2d_direct`` is the f32 direct-conv oracle.
"""
from __future__ import annotations

import math
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
        from ..nn.pooling import relu as relu_
        y = relu_(y)
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


def conv2d_direct(x, w, *, stride: int = 1, padding: str = "SAME"):
    """Direct conv oracle in f32 (``F.conv2d``, TF32 off), NHWC x, HWIO w,
    lax's SAME / VALID padding; returns x's dtype.  The reference's lax
    ``conv2d_direct``; no served path calls it."""
    # function-level import: kernels sit above core in the package graph
    from ..kernels.conv.ref import conv2d_ref
    return conv2d_ref(x, w, stride=stride, padding=padding)


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


def conv2d_hbm_bytes(B: int, H: int, W: int, C: int, K: int, r: int,
                     m: int | None, *, dtype_bytes: int = 4,
                     c_block: int | None = None, k_block: int = 128,
                     row_block: int = 8, pool_row_block: int | None = None,
                     padding: str = "SAME", stride: int = 1,
                     relu: bool = True, fuse_lrn: bool = False,
                     fuse_pool: bool = False, pool_window: int = 3,
                     pool_stride: int = 2, groups: int = 1,
                     route: str = "pallas", batch_block: int = 8,
                     weight_prefetch: bool = True,
                     row_parallel: bool = False) -> dict:
    """Modeled HBM traffic for one conv *layer*, per resolved datapath.

    ``route`` is the resolved datapath (``nn.conv.MODEL_ROUTES`` maps
    ``nn.conv.resolve_kernel``'s names onto these):

    * ``"pallas"`` — the stream-buffered kernels (the port's route of that
      name: ``cuda-winograd`` / ``cuda-direct``).  ``m`` set models the
      Winograd kernel's halo-padded tile slab; ``m=None`` models the
      strided *direct* kernel (AlexNet conv1's 11x11 s4, conv2's 5x5): a
      ``(npr-1)*s*ps*Pb + s*(Rc-1)+r`` row slab at width ``s*(out_w-1)+r``
      — the strided-fused layer terms.  Fusion flags are honored
      *in-kernel*, so the fused layer writes only the final map.
    * ``"winograd"`` — the pure-tensor path: the overlapping-tile tensor
      (B, th, tw, n, n, C) is materialized in HBM (written once, read
      once) on top of the raw read — the ~(n/m)^2 inflation of §3.5.  No
      on-chip fusion: fused == unfused.
    * ``"direct"`` / ``"lax"`` — the library conv: raw read once.  The
      epilogue runs as separate ops, so no fusion credit: fused ==
      unfused.

    Input re-fetch (pallas): with one channel block (``c_block=None``
    auto-sizes so AlexNet layers qualify) and no groups, the slab block
    index is constant across the (row, k) revisits and the repeated copy
    is elided; grouped layers cycle each group's slab once per row
    block, and multiple c blocks re-stream the slab per
    (row-block, k-block) revisit.

    Output side — the unfused baseline is the paper's strawman (§3.5: in
    prior work "the output of each stage goes to DDR and back"): conv
    writes the full-resolution map, bias+ReLU / LRN each read+rewrite it,
    pool reads it and writes the pooled map.  Fused (pallas), only the
    final normalized/pooled map is written once.

    Weight side (reported separately from the layer totals, which count
    feature maps only): the batch-innermost filter-cache grid fetches each
    weight tile once per ``batch_block`` images; ``weight_hbm_nocache_bytes``
    is the batch-outermost grid's once-per-image stream for comparison.
    The double-buffered weight stream splits the fetched bytes into
    *exposed* vs *prefetch-hidden*: with ``weight_prefetch`` only each
    filter-cache generation's warmup tile (``weight_tile_bytes`` x
    batch-outer blocks) is exposed — every later fetch is issued one
    transition early and overlaps compute — while without it all
    ``weight_fetches`` synchronous copies stall the PEs
    (``weight_exposed_prefetch_bytes`` / ``weight_exposed_noprefetch_bytes``
    report both; ``weight_hbm_exposed_bytes`` follows the flag).  With
    ``row_parallel`` the multi-tile stream restarts per *row block*, so
    one warmup tile is exposed per (batch-outer, row) block instead of per
    batch-outer block.  Non-pallas routes have no in-kernel stream:
    everything is exposed.

    Keys ``layer_unfused_bytes``/``layer_fused_bytes`` compare fused vs
    unfused *on this route*; ``layer_unfused_direct_bytes`` is the direct
    stagewise baseline every route is measured against.  The formulas and
    keys are the reference's (``repro/core/winograd.py``), so both
    packages model one layer alike.
    """
    g = groups
    if padding == "SAME":
        out_h, out_w = -(-H // stride), -(-W // stride)
    else:
        out_h = (H - r) // stride + 1
        out_w = (W - r) // stride + 1
    raw = B * H * W * C * dtype_bytes
    ph = max((out_h - pool_window) // pool_stride + 1, 0)
    pw = max((out_w - pool_window) // pool_stride + 1, 0)
    Cg, Kg = C // g, K // g                     # per-group extents

    Bb = max(1, min(batch_block, B))

    def _blocks(hp, wp):
        Cb = (auto_c_block(hp, wp, Cg, batch=Bb, dtype_bytes=dtype_bytes)
              if c_block is None else min(c_block, Cg))
        ncb = -(-Cg // Cb)
        Kb = min(k_block, Kg)
        nkb = Kg // Kb if Kg % Kb == 0 else 1   # kernel widens Kb to Kg
        return Cb, ncb, nkb

    def _wino_plan(with_pool):
        t = winograd_transform(m, r)
        tw = -(-out_w // t.m)
        if with_pool:
            q = t.m // math.gcd(pool_stride, t.m)
            if pool_row_block is None:
                Pb = auto_pool_rows(ph, pool_window, pool_stride, align=q,
                                    row_align=t.m, cols=tw * t.m, kfull=K,
                                    batch=Bb, dtype_bytes=dtype_bytes)
            else:
                Pb = q * (-(-max(min(pool_row_block, ph), 1) // q))
            row_step = pool_stride * Pb // t.m
            Rt = -(-(pool_stride * (Pb - 1) + pool_window) // t.m)
            npr = -(-max(ph, 1) // Pb)
            thp = (npr - 1) * row_step + Rt
        else:
            th = -(-out_h // t.m)
            Rt = min(row_block, th)
            npr = -(-th // Rt)
            thp = npr * Rt
        return thp * t.m + r - 1, tw * t.m + r - 1, npr

    def _direct_plan(with_pool):
        if with_pool:
            if pool_row_block is None:
                Pb = auto_pool_rows(ph, pool_window, pool_stride,
                                    cols=out_w, kfull=K, batch=Bb,
                                    dtype_bytes=dtype_bytes)
            else:
                Pb = max(min(pool_row_block, ph), 1)
            Rc = pool_stride * (Pb - 1) + pool_window
            step_in = stride * pool_stride * Pb
            npr = -(-max(ph, 1) // Pb)
        else:
            Rc = min(row_block, out_h)
            step_in = stride * Rc
            npr = -(-out_h // Rc)
        in_rows = stride * (Rc - 1) + r
        return (npr - 1) * step_in + in_rows, stride * (out_w - 1) + r, npr

    def _stream(with_pool):
        hp, wp, npr = (_wino_plan(with_pool) if m is not None
                       else _direct_plan(with_pool))
        Cb, ncb, nkb = _blocks(hp, wp)
        # the slab block index (k // nkb) * ncb + c is constant across every
        # step only when g == 1 and ncb == 1 (one fetch, the copy elided);
        # grouped layers cycle the group's slab per row block even with all
        # of C resident, and multiple c blocks re-stream per (row, k) revisit
        if ncb > 1:
            refetch = nkb * npr
        elif g > 1:
            refetch = npr
        else:
            refetch = 1
        return (B * hp * wp * (g * ncb * Cb) * dtype_bytes * refetch, npr,
                (Cb, ncb, nkb))

    # --- input side ---------------------------------------------------------
    if m is None:
        tile_tensor = 0
    else:
        t = winograd_transform(m, r)
        th, tw = -(-out_h // t.m), -(-out_w // t.m)
        tile_tensor = B * th * tw * t.n * t.n * C * dtype_bytes
    host_tiled = raw + 2 * tile_tensor          # read raw + write/read tiles
    if route == "pallas":
        stream, npr_f, blocks_f = _stream(fuse_pool)
        stream_unfused, npr_u, _ = _stream(False)
    elif route == "winograd":
        stream = stream_unfused = host_tiled
        npr_f = npr_u = 1
        blocks_f = None
    else:                                       # library direct
        stream = stream_unfused = raw
        npr_f = npr_u = 1
        blocks_f = None

    # --- output side: stagewise strawman vs in-kernel fused -----------------
    conv_out = B * out_h * out_w * K * dtype_bytes
    pooled = B * ph * pw * K * dtype_bytes
    final = pooled if fuse_pool else conv_out
    stage_passes = (conv_out + (2 * conv_out if relu else 0)
                    + (2 * conv_out if fuse_lrn else 0)
                    + ((conv_out + pooled) if fuse_pool else 0))
    layer_unfused = stream_unfused + stage_passes
    layer_fused = (stream + final if route == "pallas" else layer_unfused)
    layer_unfused_direct = raw + stage_passes

    # --- weight side (filter cache + double-buffered prefetch) ---------------
    wunit = (winograd_transform(m, r).n ** 2 if m is not None else r * r)
    weight_bytes = wunit * Cg * Kg * g * dtype_bytes
    Bo = -(-B // Bb)
    if route == "pallas":
        Cb, ncb, nkb = blocks_f
        Kb = Kg // nkb
        # the stream moves whole padded tiles; one (wunit, Cb, Kb) tile per
        # (k, c) transition, the stream re-running per row block and per
        # filter-cache generation (batch-outer step) — except a
        # single-tile stream, which the kernels fetch once and keep
        # resident for the whole launch (the reference's
        # dma.fetch_weight_tile)
        tile_bytes = wunit * Cb * Kb * dtype_bytes
        tiles = g * nkb * ncb
        fetches = tiles * npr_f * Bo if tiles > 1 else 1
        weight_hbm = tile_bytes * fetches
        weight_nocache = tile_bytes * (tiles * npr_f if tiles > 1 else 1) * B
        # double-buffered: only each stream generation's warmup tile is
        # exposed — one generation per batch-outer block (batch grid dim
        # stays parallel), times the row blocks when the row-parallel
        # restart is on; prefetch off exposes every fetch
        gens = Bo * (npr_f if row_parallel else 1)
        exposed_pref = tile_bytes * (gens if tiles > 1 else 1)
        exposed_nopref = weight_hbm
    else:
        weight_hbm = weight_nocache = weight_bytes
        tile_bytes = weight_bytes
        fetches = 1
        exposed_pref = exposed_nopref = weight_bytes
    weight_exposed = exposed_pref if weight_prefetch else exposed_nopref
    return {
        "route": route,
        "raw_bytes": raw,
        "host_tiled_bytes": host_tiled,
        "stream_bytes": stream,
        "stream_unfused_bytes": stream_unfused,
        "tile_inflation": tile_tensor / raw,
        "savings": host_tiled / stream,
        "conv_out_bytes": conv_out,
        "pooled_bytes": pooled,
        "final_out_bytes": final,
        "stage_pass_bytes": stage_passes,
        "layer_unfused_bytes": layer_unfused,
        "layer_fused_bytes": layer_fused,
        "layer_unfused_direct_bytes": layer_unfused_direct,
        "fused_savings": layer_unfused / layer_fused,
        "weight_bytes": weight_bytes,
        "weight_hbm_bytes": weight_hbm,
        "weight_hbm_nocache_bytes": weight_nocache,
        "filter_cache_reuse": weight_nocache / weight_hbm,
        "weight_tile_bytes": tile_bytes,
        "weight_fetches": fetches,
        "weight_exposed_prefetch_bytes": exposed_pref,
        "weight_exposed_noprefetch_bytes": exposed_nopref,
        "weight_hbm_exposed_bytes": weight_exposed,
        "weight_hbm_hidden_bytes": weight_hbm - weight_exposed,
    }


def conv_flops(h_out: int, w_out: int, c: int, k: int, r: int,
               winograd_m: int | None = None) -> tuple[int, int]:
    """(direct_madds, winograd_madds) for one image, paper Table 2 style."""
    direct = h_out * w_out * c * k * r * r
    if winograd_m is None:
        return direct, direct
    t = winograd_transform(winograd_m, r)
    tiles = -(-h_out // t.m) * (-(-w_out // t.m))
    wino = tiles * t.n * t.n * c * k
    return direct, wino
