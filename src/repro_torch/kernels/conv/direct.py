"""Strided direct conv layer: the port of the reference's ``_direct_kernel``
(``repro/kernels/conv/direct.py``), AlexNet's conv1 (11x11 stride 4) and
conv2 (5x5, groups 2) datapath on the ``pallas`` route.

``plan``/``pack_weights`` mirror the reference, so the packed slab is the
reference's slab bit for bit.  :func:`conv2d_direct` runs the CUDA kernel
(``csrc/conv_direct.cu``) on a CUDA tensor and its plain PyTorch version,
:func:`conv2d_direct_plain`, on a CPU tensor; the plain version takes the
kernel's exact arguments (input, packed slab, bias, plan, flags).

The launch geometry is pure Python here (:func:`conv_tile`,
:func:`tile_cols`, :func:`conv_grid`, :func:`smem_bytes`,
:func:`scratch_shape`, :func:`block_tile`), mirrored by the launcher, so
the CPU tests check it; each answers by the slab's dtype, which fixes the
route.  The conv stage's block tile is a knob: the f32 route is built
for the :data:`TILES`, the bf16 route for the :data:`MMA_TILES`, and
every tile of a route gives the same bits, so the measured autotuner
(``core/autotune.py``) picks one per layer on speed alone.

Element types and routes (the reference's bf16 model): x and the bias are
float32 or bfloat16, the slab is x's type, or float32 under a bfloat16 x
(a ``conv_bfp`` slab, which the reference dequantizes to f32;
:func:`check_cuda_inputs`).  An f32 slab runs on the FFMA route: the
kernel widens its inputs to f32 as it loads them, so bf16 x on an f32
slab is bit-equal to the f32 kernel on the widened inputs, rounded.  A
bf16 slab (bf16 x) runs on the tensor cores: bf16 ``mma.sync`` products,
which are the reference's exactly, summed in f32 in k-steps of 16
reduction indices.  Its sums differ from the FFMA route's by f32 noise,
so its output is within one bf16 step of the plain version and of the
FFMA route's on the widened inputs, not bit-equal to the latter.
Either route keeps the conv map in f32 and rounds only its output to x's
type, as the plain version does.

ABFT (``checksum=True``, the reference's armed variant): the slab carries
a checksum row in every tile, the kernel checks the whole slab once a
launch and the call returns ``(y, verdict)``, an int32 count of mismatched
checksum lanes (0: intact); ``y`` is bit-equal to the unarmed call's.
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

# wrapper calls that launched the CUDA kernel (the plain version does not
# count; a call is one or two launches, conv stage then epilogue stage)
launches = 0

# the conv stage's implicit-GEMM tiling, as csrc/conv_direct.cu has it
BM = 64                     # conv pixels (GEMM rows) of a default tile
TILE_COLS = (64, 96)        # output channels (columns) of a default tile
# the (rows, columns) block tiles the launcher is built for: the default
# tiles for any slab, the others for 16-byte slab copies (Kb % 4 == 0)
TILES = ((64, 64), (64, 96), (64, 128), (128, 64), (128, 96))
ANY_SLAB_TILES = ((64, 64), (64, 96))
BK = 16                     # reduction chunk (the bf16 route's k-step)
STAGES = 3                  # cp.async ring depth
ABFT_SMEM_INTS = 256        # an armed block's partial sums (csrc/abft.cuh)
# the bf16-slab route's tensor-core tiling (csrc/conv_direct_bf16.cu): its
# own block tiles (2 * rows threads), each built for any slab and any x;
# its default columns; its ring depth in k-steps and the bf16 padding of
# its A and B rows in shared memory
MMA_TILES = ((64, 64), (64, 96), (64, 128), (128, 128))
MMA_TILE_COLS = (64, 96, 128)
MMA_STAGES = 4
MMA_APAD = 8
MMA_BPAD = 8
# pooled outputs x channels one epilogue-stage block aims for
EPILOGUE_OUTPUTS = 2048


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
    checksum: bool = False  # ABFT checksum row on every weight tile

    @property
    def Kfull(self) -> int:
        return self.g * self.K

    @property
    def weights(self) -> dma.WeightPlan:
        return dma.WeightPlan(g=self.g, nkb=self.nkb, ncb=self.ncb,
                              Cb=self.Cb, Kb=self.Kb,
                              spatial=(self.r, self.r),
                              checksum=self.checksum)


def plan(x_shape, w_shape, *, stride: int = 1, padding: str = "SAME",
         pool=None, groups: int = 1, row_block: int = 8,
         pool_row_block: int | None = None, c_block: int | None = None,
         k_block: int = 128, batch_block: int = 8,
         checksum: bool = False) -> DirectPlan:
    """Derive the plan from shapes + static params.  The channel block
    follows the reference's rules (its row blocking sizes the input block
    its ``auto_c_block`` budget sees), so the slab matches its slab; the
    armed plan blocks as the unarmed one does, its tiles one row taller."""
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
                      Cb=Cb, Cp=Cp, ncb=Cp // Cb, Kb=Kb, nkb=K // Kb,
                      checksum=checksum)


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
    read from the unpacked slab (without its checksum rows).  Armed
    (``p.checksum``) it returns ``(y, mismatched checksum lanes)``."""
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
    y = apply_epilogue(y, lrn, pool).to(x.dtype).contiguous()
    return (y, dma.checksum_mismatches(w_tiles)) if p.checksum else y


def mma_route(slab_dtype) -> bool:
    """Whether a slab of this dtype runs on the bf16 tensor-core route (a
    bf16 slab, under a bf16 x) rather than the FFMA one."""
    return slab_dtype == torch.bfloat16


def route_tiles(slab_dtype=torch.float32) -> tuple:
    """The block tiles the route of a slab of ``slab_dtype`` is built
    for."""
    return MMA_TILES if mma_route(slab_dtype) else TILES


def conv_tile(p: DirectPlan, rows: int | None = None,
              cols: int | None = None, *,
              slab_dtype=torch.float32) -> tuple[int, int]:
    """The conv stage's (rows, columns) block tile on the route of a slab
    of ``slab_dtype``.  A None side takes the default: BM rows, and of
    the route's default column counts (the FFMA route: 64 or 96; the
    tensor-core route: 64, 96 or 128) the one that pads K least, the
    narrowest on a tie (more blocks in flight: conv2's 64 x 64 beat its
    64 x 128 on the card, PERF.md §6).  A tile the launcher is not
    built for for this slab raises; it never falls back to another
    tile."""
    mma = mma_route(slab_dtype)
    if cols is None:
        cols = min(MMA_TILE_COLS if mma else TILE_COLS,
                   key=lambda bn: (-(-p.K // bn) * bn, bn))
    tile = (BM if rows is None else rows, cols)
    tiles = route_tiles(slab_dtype)
    if tile not in tiles:
        route = "bf16 tensor-core" if mma else "f32"
        raise ValueError(f"conv_direct's {route} route is not built for a "
                         f"{tile} block tile (rows, columns); it is built "
                         f"for {tiles}")
    if not mma and tile not in ANY_SLAB_TILES and p.Kb % 4:
        raise ValueError(f"conv_direct's {tile} block tile takes 16-byte "
                         f"slab copies, and this slab's Kb = {p.Kb} is not "
                         f"a multiple of 4; tiles for any slab: "
                         f"{ANY_SLAB_TILES}")
    return tile


def _tile(p, tile, slab_dtype):
    return conv_tile(p, *(tile or (None, None)), slab_dtype=slab_dtype)


def tile_cols(p: DirectPlan, tile=None, *, slab_dtype=torch.float32) -> int:
    """Output channels (GEMM columns) of one conv-stage block tile
    (``tile``: (rows, columns), None sides default; see :func:`conv_tile`)."""
    return _tile(p, tile, slab_dtype)[1]


def conv_grid(p: DirectPlan, B: int, tile=None, *,
              slab_dtype=torch.float32) -> tuple[int, int, int]:
    """The conv stage's grid: (M tiles, N tiles, groups), M = B * out_h *
    out_w conv pixels in tiles of the block tile's rows."""
    rows, cols = _tile(p, tile, slab_dtype)
    return -(-(B * p.out_h * p.out_w) // rows), -(-p.K // cols), p.g


def block_threads(tile, slab_dtype=torch.float32) -> int:
    """Threads of one conv-stage block: 256 on the FFMA route, two a tile
    row (rows / 32 x 2 warps) on the tensor-core route."""
    return 2 * tile[0] if mma_route(slab_dtype) else 256


def smem_bytes(p: DirectPlan, tile=None, *, slab_dtype=torch.float32) -> int:
    """Dynamic shared memory of one conv-stage block (as
    ``repro_conv_direct`` sizes it).  The FFMA route: the A ring (rows x
    (BK + 4) floats a stage), the B ring (BK x columns), two ints per
    reduction index and, armed, the ABFT partial sums.  The tensor-core
    route: its bf16 rings (rows x (BK + 8) and BK x (columns + 8) a
    stage) or the f32 rows x columns conv tile of an LRN in the stage,
    whichever is larger, two ints per reduction index and one a column,
    and, armed, one int a thread."""
    rows, cols = _tile(p, tile, slab_dtype)
    R = p.r * p.r * p.C
    if mma_route(slab_dtype):
        ring = 2 * MMA_STAGES * (rows * (BK + MMA_APAD)
                                 + BK * (cols + MMA_BPAD))
        armed = block_threads((rows, cols), slab_dtype) if p.checksum else 0
        return max(ring, 4 * rows * cols) + 4 * (2 * R + cols + armed)
    return (STAGES * (rows * (BK + 4) + BK * cols) + 2 * R
            + (ABFT_SMEM_INTS if p.checksum else 0)) * 4


def lrn_in_conv_stage(p: DirectPlan, lrn, tile=None, *,
                      slab_dtype=torch.float32) -> bool:
    """Whether the conv stage applies the LRN itself: one block tile holds
    all of a pixel's channels (one group, K <= the tile's columns)."""
    return lrn is not None and p.g == 1 and p.K <= tile_cols(
        p, tile, slab_dtype=slab_dtype)


def scratch_shape(p: DirectPlan, B: int, lrn, pool, tile=None, *,
                  slab_dtype=torch.float32) -> tuple | None:
    """The conv map y (LRN'd where the conv stage applies the LRN) that the
    conv stage writes for the second launch to pool, or to LRN and pool,
    (B, out_h, out_w, g*K) f32 whatever x's type; None when there is no
    pool and no LRN left, and the conv stage writes the output itself."""
    pooled = pool is not None and tuple(pool) != (1, 1)
    if not pooled and (lrn is None or lrn_in_conv_stage(
            p, lrn, tile, slab_dtype=slab_dtype)):
        return None
    return (B, p.out_h, p.out_w, p.Kfull)


def block_tile(Kfull: int) -> int:
    """Pooled outputs per side of one epilogue-stage block: about
    ``EPILOGUE_OUTPUTS`` outputs (pixels x channels) a block."""
    PT = 1
    while (PT + 1) ** 2 * Kfull <= EPILOGUE_OUTPUTS:
        PT += 1
    return PT


def dtype_code(dtype) -> int:
    """``ConvArgs``' element-type code of a torch dtype."""
    return build.DTYPE_CODES[str(dtype).removeprefix("torch.")]


def conv_args(x, p, *, relu: bool, lrn, pool, PT: int, pad: tuple,
              out_hw: tuple, slab_dtype=None,
              verdict=None) -> build.ConvArgs:
    """The C launcher's geometry struct (shared with the Winograd wrapper);
    ``slab_dtype`` is the slab's element type (None: x's), ``verdict``
    (armed plans) the int32 tensor the launch adds to."""
    B, H, W, Ct = x.shape
    pwin, ps = pool if pool is not None else (1, 1)
    return build.ConvArgs(
        B=B, H=H, W=W, Ct=Ct, g=p.g, C=p.C, K=p.K, r=p.r,
        s=getattr(p, "s", 1), pad_h=pad[0], pad_w=pad[1],
        out_h=p.out_h, out_w=p.out_w, ncb=p.ncb, Cb=p.Cb, nkb=p.nkb,
        Kb=p.Kb, Cs=p.weights.tap_rows, relu=int(relu),
        lrn_n=lrn.n if lrn is not None else 0,
        lrn_k=lrn.k if lrn is not None else 0.0,
        lrn_alpha=lrn.alpha if lrn is not None else 0.0,
        lrn_beta=lrn.beta if lrn is not None else 0.0,
        pwin=pwin, ps=ps, ph_out=out_hw[0], pw_out=out_hw[1], PT=PT,
        xdt=dtype_code(x.dtype),
        sdt=dtype_code(x.dtype if slab_dtype is None else slab_dtype),
        verdict=verdict.data_ptr() if p.checksum else None)


# the element types of x the conv kernels take (the bias takes x's)
X_DTYPES = (torch.float32, torch.bfloat16)


def check_cuda_inputs(name: str, x, w_tiles, bias, kfull: int,
                      verdict=None, *, slab_dtype=None):
    """Device, dtype, contiguity and bias-shape checks every CUDA wrapper
    runs before it hands raw pointers to a kernel (the plan already ties
    the input's and the slab's shapes to the launch geometry), and of an
    armed call's verdict: one int32 on the same device.  x is float32 or
    bfloat16, the bias x's type, the slab ``slab_dtype`` (a dtype or a
    tuple of them; None: x's type, as the reference packs the direct
    slab)."""
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be float32 or bfloat16; got "
                         f"{x.dtype}")
    want = {"x": (x.dtype,), "bias": (x.dtype,),
            "slab": ((x.dtype,) if slab_dtype is None
                     else tuple(slab_dtype) if isinstance(slab_dtype, tuple)
                     else (slab_dtype,))}
    for what, t in (("x", x), ("slab", w_tiles), ("bias", bias)):
        if t.device != x.device or t.dtype not in want[what] \
                or not t.is_contiguous():
            raise ValueError(f"{name}: the {what} must be a contiguous "
                             f"{' or '.join(map(str, want[what]))} tensor "
                             f"on {x.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if tuple(bias.shape) != (kfull,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != "
                         f"({kfull},)")
    if verdict is not None and (verdict.device != x.device
                                or verdict.dtype != torch.int32
                                or verdict.numel() != 1):
        raise ValueError(f"{name}: the verdict must be one int32 on "
                         f"{x.device}; got {verdict.dtype} "
                         f"{tuple(verdict.shape)} on {verdict.device}")


def new_verdict(x, verdict=None):
    """The int32 0-dim tensor an armed call adds its count to: ``verdict``
    when the caller passes one (a forward sums its layers into one), else
    a fresh zero on x's device."""
    if verdict is None:
        return torch.zeros((), dtype=torch.int32, device=x.device)
    return verdict


def _conv2d_direct_cuda(x, w_tiles, bias, p: DirectPlan, *, relu, lrn,
                        pool, verdict=None, tile=None):
    global launches
    # the slab is x's type, or f32 (a conv_bfp slab, dequantized to f32 as
    # the reference does) under a bf16 x
    check_cuda_inputs("conv_direct", x, w_tiles, bias, p.Kfull, verdict,
                      slab_dtype=(x.dtype, torch.float32))
    tile = _tile(p, tile, w_tiles.dtype)
    B = x.shape[0]
    out = torch.empty((B, p.ph_out, p.pw_out, p.Kfull), device=x.device,
                      dtype=x.dtype)
    shape = scratch_shape(p, B, lrn, pool, tile, slab_dtype=w_tiles.dtype)
    y = out if shape is None else torch.empty(shape, device=x.device,
                                              dtype=torch.float32)
    args = conv_args(x, p, relu=relu, lrn=lrn, pool=pool,
                     PT=block_tile(p.Kfull), pad=(p.ph_lo, p.pw_lo),
                     out_hw=(p.ph_out, p.pw_out), slab_dtype=w_tiles.dtype,
                     verdict=verdict)
    err = build.library().lib.repro_conv_direct(
        ctypes.byref(args), x.data_ptr(), w_tiles.data_ptr(),
        bias.data_ptr(), y.data_ptr(), out.data_ptr(), tile[0] // 16,
        tile[1] // 16, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv_direct")
    launches += 1
    return (out, verdict) if p.checksum else out


def conv2d_direct(x, w, b=None, w_packed=None, *, stride: int = 1,
                  padding: str = "SAME", relu: bool = False, groups: int = 1,
                  lrn=None, pool=None, row_block: int = 8,
                  pool_row_block: int | None = None,
                  c_block: int | None = None, k_block: int = 128,
                  batch_block: int = 8, weight_prefetch: bool = True,
                  checksum: bool = False, verdict=None,
                  tile_rows: int | None = None,
                  tile_cols: int | None = None):
    """x (B,H,W,C); w (r,r,C//groups,K); any r/stride/groups, fused layer
    (bias, ReLU, cross-channel LRN, VALID max-pool).

    ``w_packed`` is a slab staged by ``nn.conv.pack_conv_weights``.  The
    reference's TPU knobs (``row_block``, ``pool_row_block``,
    ``batch_block``) shape only the slab plan; both ``weight_prefetch``
    values launch the same kernel, whose cp.async ring always stages the
    weights ahead of their use.  ``tile_rows``/``tile_cols`` pick the conv
    stage's block tile on the slab's route (:func:`conv_tile`; None: the
    default); the plain version checks the tile and computes the same
    function.

    ``checksum=True`` (ABFT) returns ``(y, verdict)``: the slab's
    mismatched checksum lanes added to ``verdict`` (an int32 0-dim tensor;
    a fresh zero when None).
    """
    p = plan(tuple(x.shape), tuple(w.shape), stride=stride, padding=padding,
             pool=pool, groups=groups, row_block=row_block,
             pool_row_block=pool_row_block, c_block=c_block,
             k_block=k_block, batch_block=batch_block, checksum=checksum)
    w_tiles = dma.resolve_slab(w, w_packed, p.weights,
                               lambda w: pack_weights(w, p))
    tile = conv_tile(p, tile_rows, tile_cols, slab_dtype=w_tiles.dtype)
    bias = (torch.zeros((p.Kfull,), device=x.device, dtype=x.dtype)
            if b is None else b)
    verdict = new_verdict(x, verdict) if checksum else None
    if x.device.type == "cpu":
        y = conv2d_direct_plain(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                                pool=pool)
        return add_plain_verdict(y, verdict)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct: unsupported device {x.device}")
    return _conv2d_direct_cuda(x, w_tiles, bias, p, relu=relu, lrn=lrn,
                               pool=pool, verdict=verdict, tile=tile)


def add_plain_verdict(y, verdict):
    """An armed plain version's ``(y, count)`` with the count added into
    the caller's verdict (unarmed: ``y`` as it is)."""
    if verdict is None:
        return y
    y, count = y
    verdict += count
    return y, verdict
