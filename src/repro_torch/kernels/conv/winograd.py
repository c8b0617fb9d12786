"""Winograd conv kernels: the port of the reference's ``_dw1d_kernel``,
``_conv2d_kernel`` and ``_conv2d_fused_kernel``
(``repro/kernels/conv/winograd.py``).

:func:`conv1d_depthwise_causal` is kernel 7, Mamba-2's depthwise causal
1-D conv by F(m, r) for r = 2..11 taps at the reference's m = {3: 4, 4:
3}.get(r, 2) (F(3,4) for Mamba-2's 4; ``csrc/dw1d.cu`` on a CUDA tensor,
the plain version :func:`conv1d_depthwise_causal_plain`, any m, on a CPU
tensor), and
:func:`conv1d_depthwise_causal_dx` / :func:`conv1d_depthwise_causal_wgrad`
its backward: kernel 7 time-reversed on the cotangent, and a
deterministic two-pass reduction for dw and db.  The rest is the
F(m,3) x F(m,3) conv layers for m = 2..10 (:data:`CONV_MS`), AlexNet
conv3-conv5 and VGG-16's layers on the ``pallas`` route.

``plan``/``pack_weights`` mirror the reference, so the packed slab (the
G w G^T-transformed filters in the tile layout) matches it.
:func:`conv2d_winograd` runs ``csrc/conv_winograd.cu`` on a CUDA tensor —
the unfused kernel for bias+ReLU layers, the fused kernel when LRN or a
pool follows — and the plain PyTorch version :func:`conv2d_winograd_plain`
on a CPU tensor.  With ``checksum=True`` (ABFT) the slab carries a checksum
row in every tile, the GEMM stage checks the whole slab once a launch, and
the call returns ``(y, verdict)`` (see ``kernels/conv/direct.py``).  The
batched GEMM's block tile is a knob, as kernel 1's is: the launcher is
built for the :data:`TILES`, and every tile gives the same bits.  x and
the bias are float32 or bfloat16 and the slab always float32, as the
reference packs it (its G w G^T stays f32 in a bf16 model); U, M and the
conv map stay f32, and only the output is in x's type.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.winograd import auto_pool_rows, tiles_2d, transform_tensors, \
    winograd_transform
from ...core.winograd import conv1d_depthwise_causal as \
    conv1d_depthwise_causal_f32
from ...core import opcount
from ...nn.pooling import apply_epilogue
from .. import build
from . import dma
from .direct import ABFT_SMEM_INTS, add_plain_verdict, check_cuda_inputs, \
    conv_args, new_verdict
from .epilogue import batch_blocks, channel_blocks, grouped_channel_pad, \
    k_blocks

# wrapper calls that launched the CUDA kernels (the plain versions do not
# count; a 2-D call is three or four launches, one of the counts below)
launches = 0          # unfused: conv + bias + ReLU
fused_launches = 0    # fused: + LRN and/or max-pool
dw1d_launches = 0     # kernel 7: depthwise causal 1-D
dw1d_bwd_launches = 0     # kernel 7 time-reversed: the backward's dx
dw1d_wgrad_launches = 0   # the backward's dw and db (two launches a call)

# the batched GEMM's tiling, as csrc/conv_winograd.cu has it
BM = 64                     # Winograd tiles (GEMM rows) of the default tile
BN = 64                     # output channels (GEMM columns) of the default
# the (rows, columns) block tiles the launcher is built for: the default
# for any slab, the others for 16-byte slab copies (Kb % 4 == 0)
TILES = ((64, 64), (32, 64), (64, 32), (128, 64))
ANY_SLAB_TILES = ((64, 64),)
BK = 16                     # input channels a chunk (U's channel pad)
STAGES = 3                  # cp.async ring depth


# ---------------------------------------------------------------------------
# 1D depthwise causal (Mamba conv, k taps -> F(m, k))
# ---------------------------------------------------------------------------
_DW1D_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tap counts csrc/dw1d.cu is built for, each at the reference's m
DW1D_TAPS = tuple(range(2, 12))
# csrc/dw1d.cu's blocking: channels a block (128 lanes, two channels each)
# and the Winograd tiles (m output rows each) of a block it is built for.
# The wrapper takes the most tiles a block whose blocks number at least
# DW1D_MIN_BLOCKS (two an SM on the H100's 132), else one tile
DW1D_CHANNELS = 256
DW1D_TILES = (4, 2, 1)
DW1D_MIN_BLOCKS = 264


def dw1d_m(r: int, m: int | None = None) -> int:
    """The Winograd tile's outputs for ``r`` taps: ``m``, or the
    reference's default {3: 4, 4: 3}.get(r, 2)."""
    return m or {3: 4, 4: 3}.get(r, 2)


def dw1d_runs(L: int, tiles: int, m: int = 3) -> int:
    """Runs of ``tiles`` Winograd tiles of ``m`` rows that cover L rows."""
    return math.ceil(math.ceil(L / m) / tiles)


def dw1d_grid(B: int, L: int, C: int, tiles: int, m: int = 3) -> tuple:
    """(channel blocks, runs, batch): csrc/dw1d.cu's grid, one run of
    ``tiles`` tiles of ``m`` rows a block."""
    return math.ceil(C / DW1D_CHANNELS), dw1d_runs(L, tiles, m), B


@functools.lru_cache(maxsize=None)
def dw1d_launch(B: int, L: int, C: int, m: int = 3) -> int:
    """Tiles a block: a function of the shape and m only; the output does
    not depend on it."""
    cx = math.ceil(C / DW1D_CHANNELS) * B
    return next((t for t in DW1D_TILES
                 if dw1d_runs(L, t, m) * cx >= DW1D_MIN_BLOCKS), 1)


def conv1d_depthwise_causal_plain(x, w, b, m: int | None = None):
    """Kernel 7's function in PyTorch: the pure-torch Winograd F(m, r) on
    f32 copies (tiles, transforms, products and the bias in f32), then one
    rounding to x's dtype.  x (B,L,C); w (r,C); b (C,)."""
    return conv1d_depthwise_causal_f32(x.float(), w.float(), b.float(),
                                       m=m).to(x.dtype)


def conv1d_depthwise_causal_dx_plain(dy, w, m: int | None = None):
    """The backward's dx in PyTorch, the reference's formula: kernel 7's
    function on the time-reversed cotangent, no bias, reversed back.
    dx[s] = sum_k w[k] dy[s + r-1-k]; dy (B,L,C) -> (B,L,C) in dy's
    dtype."""
    zero = torch.zeros((w.shape[1],), dtype=torch.float32, device=w.device)
    return conv1d_depthwise_causal_plain(dy.flip(1), w, zero, m).flip(1)


def conv1d_depthwise_causal_wgrad_plain(x, dy, r: int):
    """The backward's dw and db in PyTorch, the reference's formula:
    dw[k, c] = sum_{b,t} dy[b,t,c] x[b,t-r+1+k,c] summed in f32 (r, C),
    and db = dy summed over (b, t) in dy's dtype, widened to f32 (C,)."""
    L = x.shape[1]
    xp = F.pad(x, (0, 0, r - 1, 0)).float()
    g = dy.float()
    dw = torch.stack([torch.einsum("blc,blc->c", g, xp[:, k:k + L])
                      for k in range(r)])
    return dw, dy.sum(dim=(0, 1)).float()


def dw1d_work(B, L, C, itemsize, r=4):
    """(operations, bytes) of one depthwise causal conv of r taps: the
    function's work, r multiply-adds and a bias add an output (2 r + 1
    operations), not the Winograd transforms that compute it; bytes: x
    and out in x's dtype, w (r, C) and b in f32."""
    flops = (2 * r + 1) * B * L * C
    nbytes = 2 * itemsize * B * L * C + 4 * (r + 1) * C
    return flops, nbytes


def dw1d_bwd_work(B, L, C, itemsize, kind, r=4):
    """(operations, bytes) of the backward's dx (kernel 7 on the reversed
    cotangent: the forward's work, dy read and dx written once) or of its
    wgrad (x and dy read once, dw and db written in f32; 2 r + 1
    operations an element: r multiply-adds and an add)."""
    if kind == "dx":
        return dw1d_work(B, L, C, itemsize, r)
    return ((2 * r + 1) * B * L * C,
            2 * itemsize * B * L * C + 4 * (r + 1) * C)


@functools.lru_cache(maxsize=None)
def _dw1d_mats(m: int = 3, r: int = 4) -> np.ndarray:
    """B^T (n x n), G (n x r) and A^T (m x n) of F(m, r) as one f32 host
    array (F(3,4) by default, Mamba-2's 4 taps); cached, so it outlives
    the launch that reads it through its address."""
    t = winograd_transform(m, r)
    return np.ascontiguousarray(np.concatenate(
        [t.BT.reshape(-1), t.G.reshape(-1), t.AT.reshape(-1)]).astype(
            np.float32))


def _check_dw1d_cuda(r: int, m: int, *xs):
    """The kernel's (m, r) and the inputs' dtypes, layout and devices."""
    if r not in DW1D_TAPS or m != dw1d_m(r):
        raise ValueError(
            f"conv1d_depthwise_causal: the CUDA kernel is built for r in "
            f"{DW1D_TAPS[0]}..{DW1D_TAPS[-1]} taps at the reference's m "
            f"({{3: 4, 4: 3}}.get(r, 2)); got F({m},{r})")
    for x in xs:
        if x.dtype not in _DW1D_DTYPE_CODE or not x.is_contiguous():
            raise ValueError(f"conv1d_depthwise_causal: the kernel takes a "
                             f"contiguous {list(_DW1D_DTYPE_CODE)} x; got "
                             f"{x.dtype}, contiguous={x.is_contiguous()}")
        if x.dtype != xs[0].dtype or x.shape != xs[0].shape or \
                x.device != xs[0].device:
            raise ValueError("conv1d_depthwise_causal: x and dy differ in "
                             "dtype, shape or device")


def _conv1d_depthwise_causal_cuda(x, w, b, *, m: int | None = None,
                                  reverse: bool = False):
    """Kernel 7; ``reverse`` reads and writes the rows time-reversed (the
    backward's dx, counted in :data:`dw1d_bwd_launches`)."""
    global dw1d_launches, dw1d_bwd_launches
    r = w.shape[0]
    m = dw1d_m(r, m)
    _check_dw1d_cuda(r, m, x)
    w = w.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    for t in (w, b):
        if t.device != x.device:
            raise ValueError(f"conv1d_depthwise_causal: weights on "
                             f"{t.device}, x on {x.device}")
    B, L, C = x.shape
    out = torch.empty_like(x)
    if x.device.type == "meta":
        opcount.record_kernel("dw1d_bwd" if reverse else "dw1d",
                              *dw1d_work(B, L, C, x.element_size(), r))
        return out
    mats = _dw1d_mats(m, r)
    err = build.library().lib.repro_dw1d(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), mats.ctypes.data,
        out.data_ptr(), B, L, C, m, r, dw1d_launch(B, L, C, m),
        int(reverse), _DW1D_DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dw1d_bwd" if reverse else "dw1d")
    if reverse:
        dw1d_bwd_launches += 1
    else:
        dw1d_launches += 1
    return out


# csrc/dw1d.cu's wgrad blocking: 128 channels a block, one a lane; the
# wrapper splits each batch row's time steps so that the blocks number at
# least DW1D_WGRAD_MIN_BLOCKS (eight an SM on the H100's 132), with at
# least DW1D_WGRAD_MIN_ROWS steps a split
DW1D_WGRAD_CHANNELS = 128
DW1D_WGRAD_MIN_BLOCKS = 1056
DW1D_WGRAD_MIN_ROWS = 16


@functools.lru_cache(maxsize=None)
def dw1d_wgrad_rows(B: int, L: int, C: int) -> int:
    """Time steps a block of the wgrad kernel: a function of the shape
    only (the sums' order, and so the bits, depend on it)."""
    cx = math.ceil(C / DW1D_WGRAD_CHANNELS) * B
    splits = max(1, min(math.ceil(L / DW1D_WGRAD_MIN_ROWS),
                        math.ceil(DW1D_WGRAD_MIN_BLOCKS / cx)))
    return math.ceil(L / splits)


def dw1d_wgrad_scratch_shape(B: int, L: int, C: int, r: int = 4) -> tuple:
    """The f32 partial sums: (batch row x split, r + 1 sums (the r taps'
    and dy's), C)."""
    return (B * math.ceil(L / dw1d_wgrad_rows(B, L, C)), r + 1, C)


def _conv1d_depthwise_causal_wgrad_cuda(x, dy, r: int):
    global dw1d_wgrad_launches
    _check_dw1d_cuda(r, dw1d_m(r), x, dy)
    B, L, C = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(dw1d_wgrad_scratch_shape(B, L, C, r), **f32)
    dw = torch.empty((r, C), **f32)
    db = torch.empty((C,), **f32)
    if x.device.type == "meta":
        opcount.record_kernel("dw1d_wgrad", *dw1d_bwd_work(
            B, L, C, x.element_size(), "wgrad", r))
        return dw, db
    err = build.library().lib.repro_dw1d_wgrad(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        db.data_ptr(), B, L, C, r, dw1d_wgrad_rows(B, L, C),
        _DW1D_DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dw1d_wgrad")
    dw1d_wgrad_launches += 1
    return dw, db


def conv1d_depthwise_causal(x, w, b=None, *, m: int | None = None):
    """x (B,L,C); w (r,C); b (C,) or None -> (B,L,C) in x's dtype: the
    left-padded causal depthwise conv by F(m, r) Winograd, f32 inside.
    ``m`` defaults to the reference's {3: 4, 4: 3}.get(r, 2) (F(3,4) for
    Mamba-2's 4 taps); the CUDA kernel takes r = 2..11 at that m, the
    plain version any m."""
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_depthwise_causal: x {tuple(x.shape)} is "
                         f"not (B, L, C) or w {tuple(w.shape)} not (r, C)")
    if b is None:
        b = torch.zeros((w.shape[1],), dtype=w.dtype, device=w.device)
    if tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"conv1d_depthwise_causal: bias {tuple(b.shape)} "
                         f"is not ({w.shape[1]},)")
    if x.device.type == "cpu":
        return conv1d_depthwise_causal_plain(x, w, b, m)
    _check_cuda_device(x)
    return _conv1d_depthwise_causal_cuda(x, w, b, m=m)


def _check_cuda_device(x):
    """The kernel's devices: the card, or meta (the dry run: the CUDA
    path's outputs and scratch, the launch recorded)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"conv1d_depthwise_causal: unsupported device "
                         f"{x.device}")


def conv1d_depthwise_causal_dx(dy, w):
    """The backward's dx: dy (B,L,C), w (r,C) -> (B,L,C) in dy's dtype.
    Kernel 7 time-reversed on a CUDA tensor (bit-equal to
    flip(kernel7(flip(dy))) with a zero bias), the plain version on a CPU
    tensor."""
    if dy.device.type == "cpu":
        return conv1d_depthwise_causal_dx_plain(dy, w)
    _check_cuda_device(dy)
    zero = torch.zeros((w.shape[1],), dtype=torch.float32, device=w.device)
    return _conv1d_depthwise_causal_cuda(dy, w, zero, reverse=True)


def conv1d_depthwise_causal_wgrad(x, dy, r: int):
    """The backward's (dw (r,C), db (C,)), both f32: dw summed in f32,
    db summed and rounded once to dy's dtype.  The two-pass reduction
    kernel on CUDA tensors (deterministic), the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return conv1d_depthwise_causal_wgrad_plain(x, dy, r)
    _check_cuda_device(x)
    return _conv1d_depthwise_causal_wgrad_cuda(x, dy, r)


# ---------------------------------------------------------------------------
# 2D conv (AlexNet 3x3 -> F(m,3) x F(m,3), m = 4 by default)
# ---------------------------------------------------------------------------
# the tile outputs m the CUDA kernels are built for at r = 3 (n = m + 2 <=
# 12, as far as winograd_transform's points reach)
CONV_MS = tuple(range(2, 11))


@dataclass(frozen=True)
class WinogradPlan:
    """Every derived extent of one call; pure function of shapes.  ``fused``
    selects the layer-fused plan (exact K tiling) vs the plain conv plan
    (K padded up to the block)."""
    fused: bool
    m: int
    r: int
    g: int
    C: int                  # channels per group
    K: int                  # out channels per group
    out_h: int
    out_w: int
    ph_pad: int             # SAME halo pad (both sides)
    tw: int                 # tile columns
    # the reference's row blocking (it sizes the slab's channel block; the
    # CUDA kernels cover every tile row of the m-grid in one launch)
    Rt: int                 # tile rows per row step
    row_step: int           # tile rows advanced per row step
    npr: int                # row steps
    rows_out: int           # output rows written per row step
    w_out: int              # output cols written per row step
    thp: int                # total tile rows the slab must cover
    Hp: int
    Wp: int
    Bb: int
    Bp: int
    Cb: int
    Cp: int
    ncb: int
    Kb: int
    Kp: int                 # K per group incl. pad (== K when fused)
    nkb: int
    ph_out: int             # pooled rows (== out_h when no pool)
    pw_out: int
    checksum: bool = False  # ABFT checksum row on every weight tile

    @property
    def n(self) -> int:
        return self.m + self.r - 1

    @property
    def Kfull(self) -> int:
        return self.g * self.K

    @property
    def weights(self) -> dma.WeightPlan:
        return dma.WeightPlan(g=self.g, nkb=self.nkb, ncb=self.ncb,
                              Cb=self.Cb, Kb=self.Kb,
                              spatial=(self.n, self.n),
                              checksum=self.checksum)


def plan(x_shape, w_shape, *, m: int = 4, padding: str = "SAME",
         groups: int = 1, lrn=None, pool=None, row_block: int = 8,
         pool_row_block: int | None = None, c_block: int | None = None,
         k_block: int = 128, batch_block: int = 8,
         checksum: bool = False) -> WinogradPlan:
    """Derive the plan from shapes + static params, every field the
    reference's at every m (the fused pool's row block a multiple of q =
    m / gcd(ps, m), so each row step starts on the m-grid).  The channel
    and K blocks follow the reference's rules (its row blocking sizes the
    input block its ``auto_c_block`` budget sees), so the slab matches its
    slab; the armed plan blocks as the unarmed one does."""
    r = w_shape[0]
    t = winograd_transform(m, r)
    mm = t.m
    B, H, W, Ct = x_shape
    g = groups
    Kt = w_shape[-1]
    assert Ct % g == 0 and Kt % g == 0 and w_shape[2] == Ct // g, (
        "grouped conv shape mismatch")
    C, K = Ct // g, Kt // g
    if padding == "SAME":
        ph_pad = r // 2
        out_h, out_w = H, W
    else:
        ph_pad = 0
        out_h, out_w = H - r + 1, W - r + 1
    tw = -(-out_w // mm)
    Bb, Bp = batch_blocks(B, batch_block)
    fused = lrn is not None or pool is not None

    ph_out, pw_out = out_h, out_w
    if fused and pool is not None:
        pwin, ps = pool
        ph_out = (out_h - pwin) // ps + 1
        pw_out = (out_w - pwin) // ps + 1
        assert ph_out >= 1 and pw_out >= 1, (
            f"pool {pool} larger than conv output {out_h}x{out_w}")
        q = mm // math.gcd(ps, mm)
        if pool_row_block is None:
            Pb = auto_pool_rows(ph_out, pwin, ps, align=q, row_align=mm,
                                cols=tw * mm, kfull=g * K, batch=Bb)
        else:
            Pb = q * (-(-min(pool_row_block, ph_out) // q))
        row_step = ps * Pb // mm
        Rt = -(-(ps * (Pb - 1) + pwin) // mm)
        npr = -(-ph_out // Pb)
        rows_out, w_out = Pb, pw_out
        thp = (npr - 1) * row_step + Rt
    else:
        th = -(-out_h // mm)
        Rt = row_step = min(row_block, th)
        npr = -(-th // Rt)
        rows_out, w_out = Rt * mm, tw * mm
        thp = (npr - 1) * row_step + Rt if fused else npr * Rt
    Hp = thp * mm + r - 1
    Wp = tw * mm + r - 1

    Cb = channel_blocks(C, c_block, Hp, Wp, Bb)
    Cp = C + (-C) % Cb
    if fused:
        Kb = k_blocks(K, k_block)
        Kp = K
    else:
        Kb = min(k_block, K)
        Kp = K + (-K) % Kb
    return WinogradPlan(fused=fused, m=m, r=r, g=g, C=C, K=K, out_h=out_h,
                        out_w=out_w, ph_pad=ph_pad, tw=tw, Rt=Rt,
                        row_step=row_step, npr=npr, rows_out=rows_out,
                        w_out=w_out, thp=thp, Hp=Hp, Wp=Wp, Bb=Bb, Bp=Bp,
                        Cb=Cb, Cp=Cp, ncb=Cp // Cb, Kb=Kb, Kp=Kp,
                        nkb=Kp // Kb, ph_out=ph_out, pw_out=pw_out,
                        checksum=checksum)


def pack_weights(w, p: WinogradPlan):
    """(r, r, C, g*K) raw filters -> (n_tiles, n, n, Cb, Kb): per-group
    G w G^T, channel/K pad, tile layout."""
    r, g, C, K = p.r, p.g, p.C, p.K
    _, G, _ = transform_tensors(p.m, r, w.device)
    wg = w.reshape(r, r, C, g, K).permute(3, 0, 1, 2, 4).float()
    wt = torch.einsum("in,gnmck,jm->gijck", G, wg, G)
    if p.Cp > C or p.Kp > K:
        wt = F.pad(wt, (0, p.Kp - K, 0, p.Cp - C))
    return dma.pack_weight_tiles(wt, p.weights)


def conv2d_winograd_plain(x, w_tiles, bias, p: WinogradPlan, *, relu: bool,
                          lrn, pool):
    """The kernels' function in plain PyTorch, from their exact arguments:
    B^T d B on the padded tiles, the n^2 Winograd-domain products against
    the unpacked slab (without its checksum rows), A^T m A, bias, ReLU,
    then (fused) LRN and pool.  Armed (``p.checksum``) it returns ``(y,
    mismatched checksum lanes)``."""
    V = dma.unpack_weight_tiles(w_tiles, p.weights).float()  # (g,n,n,Cp,Kp)
    xg, _ = grouped_channel_pad(x.float(), p.g, p.Cb)
    B, H, W, _ = x.shape
    mm, r = p.m, p.r
    th = -(-p.out_h // mm)
    need_h, need_w = th * mm + r - 1, p.tw * mm + r - 1
    xp = F.pad(xg, (0, 0, p.ph_pad, need_w - W - p.ph_pad,
                    p.ph_pad, need_h - H - p.ph_pad))
    BT, _, AT = transform_tensors(mm, r, x.device)
    U = torch.einsum("in,bhwnmc,jm->bhwijc", BT, tiles_2d(xp, mm, p.n), BT)
    ys = []
    for gi in range(p.g):
        M = torch.einsum("bhwijc,ijck->bhwijk",
                         U[..., gi * p.Cp:(gi + 1) * p.Cp],
                         V[gi, ..., :p.K])
        Y = torch.einsum("pi,bhwijk,qj->bhwpqk", AT, M, AT)
        Y = Y.permute(0, 1, 3, 2, 4, 5).reshape(B, th * mm, p.tw * mm, p.K)
        ys.append(Y[:, :p.out_h, :p.out_w])
    y = torch.cat(ys, dim=-1) + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = apply_epilogue(y, lrn, pool).to(x.dtype).contiguous()
    return (y, dma.checksum_mismatches(w_tiles)) if p.checksum else y


def num_tiles(p: WinogradPlan, B: int) -> int:
    """Winograd tiles of the m-grid over B images: the GEMM's rows T."""
    return B * -(-p.out_h // p.m) * p.tw


def tile_origin(p: WinogradPlan, t: int) -> tuple[int, int, int]:
    """(image, first conv row, first conv column) of tile t, as the input
    and inverse transforms decode it."""
    per_image = -(-p.out_h // p.m) * p.tw
    b, r = divmod(t, per_image)
    return b, (r // p.tw) * p.m, (r % p.tw) * p.m


def u_channels(p: WinogradPlan) -> int:
    """U's channel extent: C padded to a multiple of the GEMM's chunk."""
    return -(-p.C // BK) * BK


def gemm_tile(p: WinogradPlan, rows: int | None = None,
              cols: int | None = None) -> tuple[int, int]:
    """The batched GEMM's (rows, columns) block tile; a None side takes
    the default (BM, BN).  A tile the launcher is not built for for this
    slab raises; it never falls back to another tile."""
    tile = (BM if rows is None else rows, BN if cols is None else cols)
    if tile not in TILES:
        raise ValueError(f"conv_winograd is not built for a {tile} block "
                         f"tile (rows, columns); it is built for {TILES}")
    if tile not in ANY_SLAB_TILES and p.Kb % 4:
        raise ValueError(f"conv_winograd's {tile} block tile takes 16-byte "
                         f"slab copies, and this slab's Kb = {p.Kb} is not "
                         f"a multiple of 4; tiles for any slab: "
                         f"{ANY_SLAB_TILES}")
    return tile


def gemm_grid(p: WinogradPlan, B: int, tile=None) -> tuple[int, int, int]:
    """The batched GEMM's grid: (T tiles, K tiles, n^2 positions x g) for
    ``tile`` ((rows, columns), None sides default; :func:`gemm_tile`)."""
    rows, cols = gemm_tile(p, *(tile or (None, None)))
    return -(-num_tiles(p, B) // rows), -(-p.K // cols), p.n * p.n * p.g


def smem_bytes(p: WinogradPlan, tile=None) -> int:
    """Dynamic shared memory of one GEMM block (as ``repro_conv_winograd``
    sizes it): the A ring (rows x (BK + 4) floats a stage), the B ring
    (BK x columns), one int a channel of U (its slab row offset) and,
    armed, the ABFT partial sums; the other launches take none."""
    rows, cols = gemm_tile(p, *(tile or (None, None)))
    return (STAGES * (rows * (BK + 4) + BK * cols) + u_channels(p)
            + (ABFT_SMEM_INTS if p.checksum else 0)) * 4


def scratch_shapes(p: WinogradPlan, B: int, lrn, pool) -> dict:
    """The f32 scratches a call allocates (whatever x's type): U (n^2, g,
    T, Cu) from the input transform, M (n^2, g, T, K) from the GEMMs and,
    when an LRN or a pool follows, the conv map (B, out_h, out_w, g*K) the
    inverse transform writes for the epilogue launch (else None: it
    writes the output)."""
    nn, T = p.n * p.n, num_tiles(p, B)
    pooled = pool is not None and tuple(pool) != (1, 1)
    return {"u": (nn, p.g, T, u_channels(p)), "m": (nn, p.g, T, p.K),
            "conv": ((B, p.out_h, p.out_w, p.Kfull)
                     if pooled or lrn is not None else None)}


def _mats(p: WinogradPlan) -> np.ndarray:
    """B^T (n x n) then A^T (m x n) as one f32 host array: cached, so the
    array outlives the launch that reads it through its address."""
    return _wino_mats(p.m, p.r)


@functools.lru_cache(maxsize=None)
def _wino_mats(m: int, r: int) -> np.ndarray:
    t = winograd_transform(m, r)
    return np.ascontiguousarray(np.concatenate(
        [t.BT.reshape(-1), t.AT.reshape(-1)]).astype(np.float32))


def _conv2d_winograd_cuda(x, w_tiles, bias, p: WinogradPlan, *, relu, lrn,
                          pool, verdict=None, tile=None):
    global launches, fused_launches
    if p.r != 3 or p.m not in CONV_MS:
        raise ValueError(f"conv_winograd: the CUDA kernels are built for "
                         f"F(m,3), m in {CONV_MS}; got F({p.m},{p.r})")
    check_cuda_inputs("conv_winograd", x, w_tiles, bias, p.Kfull, verdict,
                      slab_dtype=torch.float32)
    tile = gemm_tile(p, *(tile or (None, None)))
    B = x.shape[0]
    out = torch.empty((B, p.ph_out, p.pw_out, p.Kfull), device=x.device,
                      dtype=x.dtype)
    # one allocation holds U, M and the conv map, in that order (U's rows
    # of Cu floats keep M 16-byte aligned)
    sizes = [math.prod(s) for s in scratch_shapes(p, B, lrn, pool).values()
             if s is not None]
    scratch = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    u = scratch.data_ptr()
    m = u + 4 * sizes[0]
    y = m + 4 * sizes[1] if len(sizes) == 3 else out.data_ptr()
    # PT = 1: an epilogue-launch block pools one output pixel's g*K
    # channels, so each thread reads one pool window
    args = conv_args(x, p, relu=relu, lrn=lrn, pool=pool, PT=1,
                     pad=(p.ph_pad, p.ph_pad), out_hw=(p.ph_out, p.pw_out),
                     slab_dtype=w_tiles.dtype, verdict=verdict)
    mats = _mats(p)     # held: the launcher reads it through its address
    err = build.library().lib.repro_conv_winograd(
        ctypes.byref(args), mats.ctypes.data, p.m, x.data_ptr(),
        w_tiles.data_ptr(), bias.data_ptr(), u, m, y, out.data_ptr(),
        tile[0] // 16, tile[1] // 16,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv_winograd")
    if p.fused:
        fused_launches += 1
    else:
        launches += 1
    return (out, verdict) if p.checksum else out


def conv2d_winograd(x, w, b=None, w_packed=None, *, m: int = 4,
                    padding: str = "SAME", relu: bool = False,
                    groups: int = 1, lrn=None, pool=None, row_block: int = 8,
                    pool_row_block: int | None = None,
                    c_block: int | None = None, k_block: int = 128,
                    batch_block: int = 8, weight_prefetch: bool = True,
                    checksum: bool = False, verdict=None,
                    tile_rows: int | None = None,
                    tile_cols: int | None = None):
    """x (B,H,W,C); w (r,r,C//groups,K); stride-1 conv via F(m,r) x F(m,r),
    fused bias, ReLU, groups and (when set) the LRN / max-pool epilogue.

    ``w_packed`` is a slab staged by ``nn.conv.pack_conv_weights``.  The
    reference's TPU knobs shape only the slab plan; both
    ``weight_prefetch`` values launch the same kernels, whose cp.async
    ring always stages the weights ahead of their use.
    ``tile_rows``/``tile_cols`` pick the GEMM's block tile
    (:func:`gemm_tile`; None: the default); the plain version checks the
    tile and computes the same function.

    ``checksum=True`` (ABFT) returns ``(y, verdict)``: the slab's
    mismatched checksum lanes added to ``verdict`` (an int32 0-dim tensor;
    a fresh zero when None).
    """
    p = plan(tuple(x.shape), tuple(w.shape), m=m, padding=padding,
             groups=groups, lrn=lrn, pool=pool, row_block=row_block,
             pool_row_block=pool_row_block, c_block=c_block,
             k_block=k_block, batch_block=batch_block, checksum=checksum)
    tile = gemm_tile(p, tile_rows, tile_cols)
    w_tiles = dma.resolve_slab(w, w_packed, p.weights,
                               lambda w: pack_weights(w, p))
    bias = (torch.zeros((p.Kfull,), device=x.device, dtype=x.dtype)
            if b is None else b)
    verdict = new_verdict(x, verdict) if checksum else None
    if x.device.type == "cpu":
        y = conv2d_winograd_plain(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                                  pool=pool)
        return add_plain_verdict(y, verdict)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_winograd: unsupported device {x.device}")
    return _conv2d_winograd_cuda(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                                 pool=pool, verdict=verdict, tile=tile)
