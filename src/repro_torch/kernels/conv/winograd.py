"""F(m,3) x F(m,3) Winograd conv layers: the port of the reference's
``_conv2d_kernel`` and ``_conv2d_fused_kernel``
(``repro/kernels/conv/winograd.py``), AlexNet conv3-conv5 on the
``pallas`` route.

``plan``/``pack_weights`` mirror the reference, so the packed slab (the
G w G^T-transformed filters in the tile layout) matches it.
:func:`conv2d_winograd` runs ``csrc/conv_winograd.cu`` on a CUDA tensor —
the unfused kernel for bias+ReLU layers, the fused kernel when LRN or a
pool follows — and the plain PyTorch version :func:`conv2d_winograd_plain`
on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.winograd import auto_pool_rows, tiles_2d, transform_tensors, \
    winograd_transform
from ...nn.pooling import apply_epilogue
from .. import build
from . import dma
from .direct import check_cuda_inputs, conv_args
from .epilogue import batch_blocks, channel_blocks, grouped_channel_pad, \
    k_blocks

# launches of the two CUDA kernels (the plain version does not count)
launches = 0          # unfused: conv + bias + ReLU
fused_launches = 0    # fused: + LRN and/or max-pool

# Winograd tiles one fused-kernel block may hold (the kernel's tile slots),
# and the shared memory its transformed-input chunk takes (kCc * kUStride)
MAX_TILES = 8
U_FLOATS = 32 * (36 * MAX_TILES + 1)
SMEM_BUDGET = 220 * 1024


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
    Cb: int
    Cp: int
    ncb: int
    Kb: int
    Kp: int                 # K per group incl. pad (== K when fused)
    nkb: int
    ph_out: int             # pooled rows (== out_h when no pool)
    pw_out: int

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
                              spatial=(self.n, self.n))


def plan(x_shape, w_shape, *, m: int = 4, padding: str = "SAME",
         groups: int = 1, lrn=None, pool=None, row_block: int = 8,
         pool_row_block: int | None = None, c_block: int | None = None,
         k_block: int = 128, batch_block: int = 8) -> WinogradPlan:
    """Derive the plan from shapes + static params.  The channel and K
    blocks follow the reference's rules (its row blocking sizes the input
    block its ``auto_c_block`` budget sees), so the slab matches its
    slab."""
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
    Bb, _ = batch_blocks(B, batch_block)
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
        thp = (npr - 1) * row_step + Rt
    else:
        th = -(-out_h // mm)
        Rt = row_step = min(row_block, th)
        npr = -(-th // Rt)
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
                        out_w=out_w, ph_pad=ph_pad, tw=tw, Cb=Cb, Cp=Cp,
                        ncb=Cp // Cb, Kb=Kb, Kp=Kp, nkb=Kp // Kb,
                        ph_out=ph_out, pw_out=pw_out)


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
    the unpacked slab, A^T m A, bias, ReLU, then (fused) LRN and pool."""
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
    return apply_epilogue(y, lrn, pool).contiguous()


def fused_block_tile(p: WinogradPlan, lrn, pool) -> int:
    """Pooled outputs per side of one fused-kernel block: the largest tile
    (at most 8) whose conv region needs at most MAX_TILES Winograd tiles
    and whose conv tile fits the shared-memory budget."""
    pwin, ps = pool if pool is not None else (1, 1)
    for PT in range(8, 0, -1):
        ct = ps * (PT - 1) + pwin
        nt = (-(-ct // p.m)) ** 2
        if nt > MAX_TILES:
            continue
        kt = (p.Kfull if lrn is not None
              else min(p.K, 32 * (MAX_TILES // nt)))
        if (ct * ct * kt + U_FLOATS) * 4 <= SMEM_BUDGET:
            return PT
    raise ValueError(f"no fused Winograd block tile fits pool {pool} with "
                     f"{p.Kfull} channels")


def smem_bytes(p: WinogradPlan, lrn, pool) -> int:
    """Dynamic shared memory one block takes (as the C launchers size it):
    the transformed-input chunk, plus the fused kernel's conv tile."""
    if not p.fused:
        return U_FLOATS * 4
    pwin, ps = pool if pool is not None else (1, 1)
    PT = fused_block_tile(p, lrn, pool)
    ct = ps * (PT - 1) + pwin
    nt = (-(-ct // p.m)) ** 2
    kt = p.Kfull if lrn is not None else min(p.K, 32 * (MAX_TILES // nt))
    return (-(-ct * ct * kt // 4) * 4 + U_FLOATS) * 4


def _mats(p: WinogradPlan) -> np.ndarray:
    t = winograd_transform(p.m, p.r)
    return np.ascontiguousarray(np.concatenate(
        [t.BT.reshape(-1), t.AT.reshape(-1)]).astype(np.float32))


def _conv2d_winograd_cuda(x, w_tiles, bias, p: WinogradPlan, *, relu, lrn,
                          pool):
    global launches, fused_launches
    if (p.m, p.r) != (4, 3):
        raise NotImplementedError(
            f"the CUDA Winograd kernels implement F(4,3) only, not "
            f"F({p.m},{p.r})")
    check_cuda_inputs("conv_winograd", x, w_tiles, bias, p.Kfull)
    mats = _mats(p)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library().lib
    pad = (p.ph_pad, p.ph_pad)
    if p.fused:
        out = torch.empty((x.shape[0], p.ph_out, p.pw_out, p.Kfull),
                          device=x.device, dtype=torch.float32)
        args = conv_args(x, p, relu=relu, lrn=lrn, pool=pool,
                         PT=fused_block_tile(p, lrn, pool), pad=pad,
                         out_hw=(p.ph_out, p.pw_out))
        err = lib.repro_conv_winograd_fused(
            ctypes.byref(args), mats.ctypes.data, x.data_ptr(),
            w_tiles.data_ptr(), bias.data_ptr(), out.data_ptr(), stream)
        build.check(err, "conv_winograd_fused")
        fused_launches += 1
        return out
    out = torch.empty((x.shape[0], p.out_h, p.out_w, p.Kfull),
                      device=x.device, dtype=torch.float32)
    args = conv_args(x, p, relu=relu, lrn=None, pool=None, PT=1, pad=pad,
                     out_hw=(p.out_h, p.out_w))
    err = lib.repro_conv_winograd(
        ctypes.byref(args), mats.ctypes.data, x.data_ptr(),
        w_tiles.data_ptr(), bias.data_ptr(), out.data_ptr(), stream)
    build.check(err, "conv_winograd")
    launches += 1
    return out


def conv2d_winograd(x, w, b=None, w_packed=None, *, m: int = 4,
                    padding: str = "SAME", relu: bool = False,
                    groups: int = 1, lrn=None, pool=None, row_block: int = 8,
                    pool_row_block: int | None = None,
                    c_block: int | None = None, k_block: int = 128,
                    batch_block: int = 8, weight_prefetch: bool = True,
                    checksum: bool = False):
    """x (B,H,W,C); w (r,r,C//groups,K); stride-1 conv via F(m,r) x F(m,r),
    fused bias, ReLU, groups and (when set) the LRN / max-pool epilogue.

    ``w_packed`` is a slab staged by ``nn.conv.pack_conv_weights``.  The
    reference's TPU knobs shape only the slab plan; both
    ``weight_prefetch`` values launch the same kernel.
    """
    if checksum:
        raise NotImplementedError(
            "ABFT (checksum=True) is not ported yet (ROADMAP Queue 1, "
            "item 1)")
    p = plan(tuple(x.shape), tuple(w.shape), m=m, padding=padding,
             groups=groups, lrn=lrn, pool=pool, row_block=row_block,
             pool_row_block=pool_row_block, c_block=c_block,
             k_block=k_block, batch_block=batch_block)
    w_tiles = dma.resolve_slab(w, w_packed, p.weights,
                               lambda w: pack_weights(w, p))
    bias = (torch.zeros((p.Kfull,), device=x.device, dtype=x.dtype)
            if b is None else b)
    if x.device.type == "cpu":
        return conv2d_winograd_plain(x, w_tiles, bias, p, relu=relu,
                                     lrn=lrn, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_winograd: unsupported device {x.device}")
    return _conv2d_winograd_cuda(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                                 pool=pool)
