"""Strided direct conv layer: the port of the reference's ``_direct_kernel``
(``repro/kernels/conv/direct.py``), AlexNet's conv1 (11x11 stride 4) and
conv2 (5x5, groups 2) datapath on the ``pallas`` route.

``plan``/``pack_weights`` mirror the reference, so the packed slab is the
reference's slab bit for bit.  :func:`conv2d_direct` runs the CUDA kernel
(``csrc/conv_direct.cu``) on a CUDA tensor and its plain PyTorch version,
:func:`conv2d_direct_plain`, on a CPU tensor; the plain version takes the
kernel's exact arguments (input, packed slab, bias, plan, flags).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core.winograd import auto_pool_rows
from ...nn.pooling import apply_epilogue
from .. import build
from . import dma
from .epilogue import batch_blocks, channel_blocks, grouped_channel_pad, \
    k_blocks
from .ref import same_pad

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# shared memory one block may use for its conv tile (of the 227 KB an H100
# block can have; the rest is headroom for the compiler's own use)
SMEM_BUDGET = 200 * 1024


@dataclass(frozen=True)
class DirectPlan:
    """Every derived extent of one call; pure function of shapes."""
    r: int
    s: int
    g: int
    C: int                  # channels per group
    K: int                  # out channels per group
    out_h: int
    out_w: int
    ph_lo: int
    pw_lo: int
    ph_out: int             # pooled output rows (== out_h when no pool)
    pw_out: int
    Cb: int
    Cp: int
    ncb: int
    Kb: int
    nkb: int

    @property
    def Kfull(self) -> int:
        return self.g * self.K

    @property
    def weights(self) -> dma.WeightPlan:
        return dma.WeightPlan(g=self.g, nkb=self.nkb, ncb=self.ncb,
                              Cb=self.Cb, Kb=self.Kb,
                              spatial=(self.r, self.r))


def plan(x_shape, w_shape, *, stride: int = 1, padding: str = "SAME",
         pool=None, groups: int = 1, row_block: int = 8,
         pool_row_block: int | None = None, c_block: int | None = None,
         k_block: int = 128, batch_block: int = 8) -> DirectPlan:
    """Derive the plan from shapes + static params.  The channel block
    follows the reference's rules (its row blocking sizes the input block
    its ``auto_c_block`` budget sees), so the slab matches its slab."""
    r, s, g = w_shape[0], stride, groups
    assert w_shape[0] == w_shape[1], "square filters only"
    B, H, W, Ct = x_shape
    Kt = w_shape[-1]
    assert Ct % g == 0 and Kt % g == 0 and w_shape[2] == Ct // g, (
        "grouped conv shape mismatch")
    C, K = Ct // g, Kt // g
    if padding == "SAME":
        out_h, ph_lo, _ = same_pad(H, r, s)
        out_w, pw_lo, _ = same_pad(W, r, s)
    else:
        ph_lo = pw_lo = 0
        out_h, out_w = (H - r) // s + 1, (W - r) // s + 1
    assert out_h >= 1 and out_w >= 1, (H, W, r, s, padding)

    Bb, _ = batch_blocks(B, batch_block)
    if pool is not None:
        pwin, ps = pool
        ph_out = (out_h - pwin) // ps + 1
        pw_out = (out_w - pwin) // ps + 1
        assert ph_out >= 1 and pw_out >= 1, (
            f"pool {pool} larger than conv output {out_h}x{out_w}")
        if pool_row_block is None:
            Pb = auto_pool_rows(ph_out, pwin, ps, cols=out_w, kfull=g * K,
                                batch=Bb)
        else:
            Pb = min(pool_row_block, ph_out)
        Rc = ps * (Pb - 1) + pwin
        step_in = s * ps * Pb
        npr = -(-ph_out // Pb)
    else:
        ph_out, pw_out = out_h, out_w
        Rc = min(row_block, out_h)
        step_in = s * Rc
        npr = -(-out_h // Rc)
    Hp = (npr - 1) * step_in + s * (Rc - 1) + r
    Wp = s * (out_w - 1) + r

    Cb = channel_blocks(C, c_block, Hp, Wp, Bb)
    Cp = C + (-C) % Cb
    Kb = k_blocks(K, k_block)
    return DirectPlan(r=r, s=s, g=g, C=C, K=K, out_h=out_h, out_w=out_w,
                      ph_lo=ph_lo, pw_lo=pw_lo, ph_out=ph_out, pw_out=pw_out,
                      Cb=Cb, Cp=Cp, ncb=Cp // Cb, Kb=Kb, nkb=K // Kb)


def pack_weights(w, p: DirectPlan):
    """(r, r, C, g*K) -> (n_tiles, r, r, Cb, Kb) tile layout."""
    r, g, C, K = p.r, p.g, p.C, p.K
    wg = w.reshape(r, r, C, g, K).permute(3, 0, 1, 2, 4)    # (g, r, r, C, K)
    if p.Cp > C:
        wg = F.pad(wg, (0, 0, 0, p.Cp - C))
    return dma.pack_weight_tiles(wg, p.weights)


def conv2d_direct_plain(x, w_tiles, bias, p: DirectPlan, *, relu: bool,
                        lrn, pool):
    """The kernel's function in plain PyTorch, from its exact arguments:
    one (B*out_h*out_w, Cp) @ (Cp, K) product per filter tap and group,
    read from the unpacked slab."""
    wg = dma.unpack_weight_tiles(w_tiles, p.weights).float()
    xg, _ = grouped_channel_pad(x.float(), p.g, p.Cb)
    B, H, W, _ = x.shape
    s, r = p.s, p.r
    hi_h = max(s * (p.out_h - 1) + r - H - p.ph_lo, 0)
    hi_w = max(s * (p.out_w - 1) + r - W - p.pw_lo, 0)
    xp = F.pad(xg, (0, 0, p.pw_lo, hi_w, p.ph_lo, hi_h))
    ys = []
    for gi in range(p.g):
        xs = xp[..., gi * p.Cp:(gi + 1) * p.Cp]
        acc = None
        for di in range(r):
            for dj in range(r):
                tap = xs[:, di:di + s * (p.out_h - 1) + 1:s,
                         dj:dj + s * (p.out_w - 1) + 1:s]
                term = tap @ wg[gi, di, dj, :, :p.K]
                acc = term if acc is None else acc + term
        ys.append(acc)
    y = torch.cat(ys, dim=-1) + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return apply_epilogue(y, lrn, pool).contiguous()


def block_tile(Kfull: int, pool) -> int:
    """Pooled outputs per side of one thread block: 4 (8 conv outputs with
    no pool), shrunk until the block's conv tile (all Kfull channels, f32)
    fits its shared-memory budget."""
    pwin, ps = pool if pool is not None else (1, 1)
    PT = 4 if pool is not None else 8
    while PT > 1 and (ps * (PT - 1) + pwin) ** 2 * Kfull * 4 > SMEM_BUDGET:
        PT -= 1
    if (ps * (PT - 1) + pwin) ** 2 * Kfull * 4 > SMEM_BUDGET:
        raise ValueError(f"conv tile of {Kfull} channels exceeds the "
                         "shared-memory budget")
    return PT


def smem_bytes(p: DirectPlan, pool) -> int:
    """Dynamic shared memory one block of the kernel takes: its conv tile
    of all Kfull channels (as ``repro_conv_direct`` sizes it)."""
    pwin, ps = pool if pool is not None else (1, 1)
    ct = ps * (block_tile(p.Kfull, pool) - 1) + pwin
    return ct * ct * p.Kfull * 4


def conv_args(x, p, *, relu: bool, lrn, pool, PT: int, pad: tuple,
              out_hw: tuple) -> build.ConvArgs:
    """The C launcher's geometry struct (shared with the Winograd wrapper)."""
    B, H, W, Ct = x.shape
    pwin, ps = pool if pool is not None else (1, 1)
    return build.ConvArgs(
        B=B, H=H, W=W, Ct=Ct, g=p.g, C=p.C, K=p.K, r=p.r,
        s=getattr(p, "s", 1), pad_h=pad[0], pad_w=pad[1],
        out_h=p.out_h, out_w=p.out_w, ncb=p.ncb, Cb=p.Cb, nkb=p.nkb,
        Kb=p.Kb, relu=int(relu), lrn_n=lrn.n if lrn is not None else 0,
        lrn_k=lrn.k if lrn is not None else 0.0,
        lrn_alpha=lrn.alpha if lrn is not None else 0.0,
        lrn_beta=lrn.beta if lrn is not None else 0.0,
        pwin=pwin, ps=ps, ph_out=out_hw[0], pw_out=out_hw[1], PT=PT)


def check_cuda_inputs(name: str, x, w_tiles, bias, kfull: int):
    """Device, dtype, contiguity and bias-shape checks every CUDA wrapper
    runs before it hands raw pointers to a kernel (the plan already ties
    the input's and the slab's shapes to the launch geometry)."""
    for t in (x, w_tiles, bias):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be a contiguous "
                             f"float32 tensor on {x.device}; got {t.dtype} "
                             f"on {t.device}, contiguous={t.is_contiguous()}")
    if tuple(bias.shape) != (kfull,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != "
                         f"({kfull},)")


def _conv2d_direct_cuda(x, w_tiles, bias, p: DirectPlan, *, relu, lrn,
                        pool):
    global launches
    check_cuda_inputs("conv_direct", x, w_tiles, bias, p.Kfull)
    out = torch.empty((x.shape[0], p.ph_out, p.pw_out, p.Kfull),
                      device=x.device, dtype=torch.float32)
    args = conv_args(x, p, relu=relu, lrn=lrn, pool=pool,
                     PT=block_tile(p.Kfull, pool), pad=(p.ph_lo, p.pw_lo),
                     out_hw=(p.ph_out, p.pw_out))
    err = build.library().lib.repro_conv_direct(
        ctypes.byref(args), x.data_ptr(), w_tiles.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv_direct")
    launches += 1
    return out


def conv2d_direct(x, w, b=None, w_packed=None, *, stride: int = 1,
                  padding: str = "SAME", relu: bool = False, groups: int = 1,
                  lrn=None, pool=None, row_block: int = 8,
                  pool_row_block: int | None = None,
                  c_block: int | None = None, k_block: int = 128,
                  batch_block: int = 8, weight_prefetch: bool = True,
                  checksum: bool = False):
    """x (B,H,W,C); w (r,r,C//groups,K); any r/stride/groups, fused layer
    (bias, ReLU, cross-channel LRN, VALID max-pool).

    ``w_packed`` is a slab staged by ``nn.conv.pack_conv_weights``.  The
    reference's TPU knobs (``row_block``, ``pool_row_block``,
    ``batch_block``) shape only the slab plan; both ``weight_prefetch``
    values launch the same kernel.
    """
    if checksum:
        raise NotImplementedError(
            "ABFT (checksum=True) is not ported yet (ROADMAP Queue 1, "
            "item 1)")
    p = plan(tuple(x.shape), tuple(w.shape), stride=stride, padding=padding,
             pool=pool, groups=groups, row_block=row_block,
             pool_row_block=pool_row_block, c_block=c_block,
             k_block=k_block, batch_block=batch_block)
    w_tiles = dma.resolve_slab(w, w_packed, p.weights,
                               lambda w: pack_weights(w, p))
    bias = (torch.zeros((p.Kfull,), device=x.device, dtype=x.dtype)
            if b is None else b)
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                                   pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct: unsupported device {x.device}")
    return _conv2d_direct_cuda(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                               pool=pool)
