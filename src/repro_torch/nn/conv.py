"""Unified conv-layer dispatch: declarative ConvSpec -> one entry point
(the reference's ``repro/nn/conv.py``).

Routes (the reference's names, so one config means the same in both
packages)
------
``direct``    ``F.conv2d`` (any kernel/stride/groups) + epilogue.
``winograd``  pure-torch F(m,r) x F(m,r) path.
``pallas``    the hand-written kernels: Winograd-eligible specs run the
              CUDA Winograd kernels (``cuda-winograd``), everything else
              the strided direct kernel (``cuda-direct``).
``auto``      ``winograd`` when eligible, else ``direct``.

SDC defense (the reference's): ``abft=True`` packs and runs the kernels'
armed variant, which returns a verdict of mismatched checksum lanes;
``fingerprint=True`` stamps a slab with a :class:`SlabFingerprint` that
the staging paths verify before a slab reaches a kernel.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace

import torch

from ..core import bfp
from ..core.winograd import conv2d_winograd
from ..kernels.conv import direct as _direct_k
from ..kernels.conv import dma as _dma
from ..kernels.conv import winograd as _winograd_k
from ..kernels.conv.direct import new_verdict
from ..kernels.conv.ops import conv2d as kernel_conv2d
from ..kernels.conv.ops import conv2d_direct as kernel_conv2d_direct
from ..kernels.conv.ref import conv2d_ref
from .pooling import LrnParams, apply_epilogue, pooled_hw
from .pooling import relu as _relu

ROUTES = ("auto", "direct", "winograd", "pallas")

# sentinel distinguishing "knob not passed" from an explicit None (= auto)
UNSET = object()


@dataclass(frozen=True)
class ConvPlan:
    """A per-layer launch plan: the reference's fields and defaults, and
    the block tile of the resolved CUDA kernel's GEMM stage.  What the
    measured autotuner (``core/autotune.py``) searches, persists and feeds
    back into :func:`dispatch_conv`; ``ConvPlan()`` is exactly the default
    launch.

    On the port the blocking knobs shape only the packed slab, and both
    ``weight_prefetch`` values and both ``row_parallel`` values launch the
    same kernels: the cp.async rings always stage the weights ahead of
    their use, and CUDA blocks are already independent over rows.
    ``tile_rows``/``tile_cols`` are the GEMM block tile (kernel 1's conv
    stage, kernels 2-3's batched GEMM); None takes the kernel's default.
    Every tile gives the same bits: each output is one thread's ordered
    FMA chain, whatever the tile."""
    batch_block: int = 8
    k_block: int = 128
    c_block: int | None = None
    pool_row_block: int | None = None
    weight_prefetch: bool = True
    row_parallel: bool = False
    route: str | None = None
    tile_rows: int | None = None
    tile_cols: int | None = None

    def __post_init__(self):
        assert self.route is None or self.route in ROUTES, self.route
        assert self.batch_block >= 1 and self.k_block >= 1

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    @classmethod
    def from_dict(cls, d: dict) -> "ConvPlan":
        """Unknown keys are ignored and missing ones default, so a plan
        the reference wrote loads here."""
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


DEFAULT_PLAN = ConvPlan()

# resolved datapath (:func:`resolve_kernel`) -> (``conv2d_hbm_bytes`` route,
# uses the Winograd transform): the one place a datapath becomes model terms
MODEL_ROUTES = {
    "cuda-winograd": ("pallas", True),
    "cuda-direct": ("pallas", False),
    "winograd": ("winograd", True),
    "direct": ("direct", False),
}


def plan_knobs(plan: "ConvPlan | None" = None, *, batch_block=UNSET,
               k_block=UNSET, c_block=UNSET, pool_row_block=UNSET,
               weight_prefetch=UNSET, row_parallel=UNSET) -> "ConvPlan":
    """Effective knobs: explicit kwarg beats plan beats default.  ``UNSET``
    marks "not passed", so an explicit None still overrides a plan."""
    base = plan if plan is not None else DEFAULT_PLAN
    kw = dict(batch_block=batch_block, k_block=k_block, c_block=c_block,
              pool_row_block=pool_row_block,
              weight_prefetch=weight_prefetch, row_parallel=row_parallel)
    return replace(base, **{k: v for k, v in kw.items() if v is not UNSET})


def conv_out_hw(extent: int, kernel: int, stride: int, padding: str) -> int:
    """Conv output extent (lax SAME/VALID semantics)."""
    return ((extent - kernel) // stride + 1 if padding == "VALID"
            else -(-extent // stride))


@dataclass(frozen=True)
class ConvSpec:
    """One 2D conv *layer* (NHWC / HWIO) with its epilogue: bias, ReLU,
    cross-channel LRN, spatial max-pool, in that order."""
    kernel: int
    stride: int = 1
    padding: str = "SAME"           # "SAME" | "VALID"
    groups: int = 1
    fuse_bias: bool = True
    relu: bool = False
    fuse_lrn: bool = False
    lrn: LrnParams = LrnParams()
    fuse_pool: bool = False
    pool_window: int = 3
    pool_stride: int = 2
    route: str = "auto"             # "auto" | "direct" | "winograd" | "pallas"
    winograd_m: int = 4

    def __post_init__(self):
        assert self.route in ROUTES, self.route
        assert self.padding in ("SAME", "VALID"), self.padding
        assert self.pool_window >= 1 and self.pool_stride >= 1

    def with_route(self, route: str) -> "ConvSpec":
        return replace(self, route=route)

    @property
    def winograd_eligible(self) -> bool:
        return self.stride == 1 and self.kernel == 3

    def out_hw(self, h: int) -> int:
        """Layer output extent for input extent ``h`` (conv then pool)."""
        h = conv_out_hw(h, self.kernel, self.stride, self.padding)
        if self.fuse_pool:
            h = pooled_hw(h, self.pool_window, self.pool_stride)
        return h


def resolve_route(spec: ConvSpec) -> str:
    """Final route after eligibility fallback (never returns "auto")."""
    if spec.route == "auto":
        return "winograd" if spec.winograd_eligible else "direct"
    if spec.route == "winograd" and not spec.winograd_eligible:
        return "direct"
    return spec.route


def resolve_kernel(spec: ConvSpec, in_hw=None) -> str:
    """The fully resolved datapath this spec executes (``cuda-winograd`` /
    ``cuda-direct`` / ``winograd`` / ``direct``).  With ``in_hw``, a fused
    pool window larger than the conv output resolves to ``direct``, as
    :func:`dispatch_conv` runs it."""
    route = resolve_route(spec)
    if route != "pallas":
        return route
    if in_hw is not None and spec.fuse_pool:
        hw = (in_hw, in_hw) if isinstance(in_hw, int) else in_hw
        if min(conv_out_hw(e, spec.kernel, spec.stride, spec.padding)
               for e in hw) < spec.pool_window:
            return "direct"
    return "cuda-winograd" if spec.winograd_eligible else "cuda-direct"


def _host_bytes(data):
    """The tensor's bytes on the host (a copy from the card), any dtype."""
    return data.detach().contiguous().cpu().view(torch.uint8).numpy()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class SlabFingerprint:
    """Pack-time identity of one staged weight slab: shape, dtype (the
    reference's names, ``"float32"``), a crc32 of the packed bytes, and the
    pack context (:func:`pack_context`).  :meth:`matches` re-derives all
    four from the live tensor, so a corrupted slab (crc), a stale one
    (context) or a mis-shaped one is caught before it reaches a kernel.
    The crc32 copies the slab to the host: verification is opt-in."""
    shape: tuple
    dtype: str
    crc32: int
    context: str | None = None

    def matches(self, pw, *, expect=None) -> bool:
        """Verify a packed slab (or a bare tensor) against this
        fingerprint; ``expect`` also pins the pack context."""
        if expect is not None and self.context != expect:
            return False
        data = getattr(pw, "data", pw)
        if data is None:
            return True
        return (tuple(data.shape) == tuple(self.shape)
                and _dtype_name(data.dtype) == self.dtype
                and zlib.crc32(_host_bytes(data)) == self.crc32)


def slab_fingerprint(data, context: str | None = None):
    """Fingerprint one packed tensor (None -> no fingerprint)."""
    if data is None:
        return None
    return SlabFingerprint(shape=tuple(data.shape),
                           dtype=_dtype_name(data.dtype),
                           crc32=zlib.crc32(_host_bytes(data)),
                           context=context)


def verify_packed(pw, *, expect: str | None = None) -> bool:
    """True iff ``pw`` (a :class:`PackedConvWeights` or anything shaped
    like one) carries an intact slab; without a fingerprint it passes."""
    fp = getattr(pw, "fingerprint", None)
    return fp is None or fp.matches(pw, expect=expect)


@dataclass(frozen=True)
class PackedConvWeights:
    """A staged weight slab: the resolved datapath it was packed for, the
    packed tensor (None when the route has no packed form), whether it is
    §3.6 BFP-quantized (a ``bfp`` slab that misses the plan is repacked
    quantized, never dropped), and its optional pack-time
    :class:`SlabFingerprint`."""
    kernel: str
    data: object
    bfp: bool = False
    fingerprint: object = None      # SlabFingerprint | None


def _spec_fusion(spec: ConvSpec):
    lrn_p = spec.lrn if spec.fuse_lrn else None
    pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
    return lrn_p, pool


def kernel_tile(kernel: str, p, knobs: ConvPlan,
                slab_dtype=torch.float32) -> tuple[int, int]:
    """The (rows, columns) GEMM block tile the resolved CUDA kernel
    launches for the plan ``p`` under ``knobs`` on a slab of
    ``slab_dtype`` (the direct kernel's route follows it); raises for a
    tile it is not built for."""
    tile = (p, knobs.tile_rows, knobs.tile_cols)
    return (_winograd_k.gemm_tile(*tile) if kernel == "cuda-winograd"
            else _direct_k.conv_tile(*tile, slab_dtype=slab_dtype))


def _kernel_weight_plan(spec: ConvSpec, kernel: str, in_shape, w_shape, *,
                        lrn, pool, knobs: ConvPlan, abft: bool = False):
    """The plan of the resolved kernel — the one source of slab shapes
    (``abft`` arms the checksum row: tiles one Cb row taller)."""
    if kernel == "cuda-winograd":
        return _winograd_k.plan(in_shape, w_shape, m=spec.winograd_m,
                                padding=spec.padding, groups=spec.groups,
                                lrn=lrn, pool=pool, c_block=knobs.c_block,
                                pool_row_block=knobs.pool_row_block,
                                k_block=knobs.k_block,
                                batch_block=knobs.batch_block,
                                checksum=abft)
    return _direct_k.plan(in_shape, w_shape, stride=spec.stride,
                          padding=spec.padding, pool=pool,
                          groups=spec.groups, c_block=knobs.c_block,
                          pool_row_block=knobs.pool_row_block,
                          k_block=knobs.k_block,
                          batch_block=knobs.batch_block, checksum=abft)


def _pack_for_plan(kernel: str, w, p, bfp_pack: bool):
    """Pack (and, under ``bfp_pack``, §3.6-quantize) the slab for a derived
    plan: shared by staging and the in-dispatch repack, so the two quantize
    alike.  Shared exponents run along each tile's Cb contraction axis.  An
    armed slab's checksum row must cover the final bits, so it is taken
    off before quantizing and computed again after."""
    pack = (_winograd_k.pack_weights if kernel == "cuda-winograd"
            else _direct_k.pack_weights)
    tiles = pack(w, p)
    if bfp_pack:
        if p.checksum:
            tiles = tiles[..., :-1, :]
        tiles = bfp.quantize_dequantize(
            tiles, block=math.gcd(p.weights.Cb, 32), axis=-2)
        if p.checksum:
            tiles = _dma.append_checksum_row(tiles)
    return tiles


def _quantize_filters(w):
    """§3.6 BFP on raw (k, k, C/g, K) filters, for the routes without a
    packed slab: shared exponents along C/g."""
    return bfp.quantize_dequantize(w, block=math.gcd(w.shape[2], 32), axis=2)


def pack_context(spec: ConvSpec, kernel: str, *, bfp_pack: bool,
                 abft: bool, knobs: ConvPlan) -> str:
    """Canonical pack-context string — everything that changes the bytes a
    slab holds (the reference's format)."""
    return (f"{kernel}:k{spec.kernel}s{spec.stride}g{spec.groups}"
            f":{spec.padding}:relu{int(spec.relu)}"
            f":lrn{int(spec.fuse_lrn)}:pool{int(spec.fuse_pool)}"
            f"w{spec.pool_window}s{spec.pool_stride}"
            f":bfp{int(bfp_pack)}:abft{int(abft)}"
            f":kb{knobs.k_block}:bb{knobs.batch_block}")


def expected_pack_context(spec: ConvSpec, in_shape, *, bfp_pack: bool = False,
                          abft: bool = False, plan: ConvPlan | None = None,
                          k_block=UNSET, batch_block=UNSET) -> str:
    """The :func:`pack_context` that :func:`pack_conv_weights` would stamp
    for these arguments, resolved the same way, so a staging path can ask
    that a cached slab was packed as it is about to dispatch
    (``WeightStager.stage(expect=...)``)."""
    knobs = plan_knobs(plan, k_block=k_block, batch_block=batch_block)
    if plan is not None and plan.route is not None:
        spec = spec.with_route(plan.route)
    kernel = resolve_kernel(spec, in_hw=(in_shape[1], in_shape[2]))
    return pack_context(spec, kernel, bfp_pack=bfp_pack, abft=abft,
                        knobs=knobs)


def pack_conv_weights(spec: ConvSpec, in_shape, w, *, bfp_pack: bool = False,
                      abft: bool = False, fingerprint: bool = False,
                      plan: ConvPlan | None = None, k_block=UNSET,
                      batch_block=UNSET) -> PackedConvWeights:
    """Build the weight slab for one conv layer ahead of its input: a pure
    function of the spec, the input *shape* (B, H, W, C) and the filters
    (Winograd transform, group/channel blocking, tile layout).  Under
    ``bfp_pack`` the slab is §3.6 BFP-quantized: the packed tiles on the
    kernel routes, the raw filters on the others.  ``abft`` packs the
    kernels' checksum row into every tile (pass the same flag to
    :func:`dispatch_conv`); ``fingerprint`` stamps a
    :class:`SlabFingerprint`, whose crc32 copies the slab to the host.  The
    plan's tile does not change the slab; a tile the kernel cannot launch
    on it raises here, before any dispatch."""
    knobs = plan_knobs(plan, k_block=k_block, batch_block=batch_block)
    if plan is not None and plan.route is not None:
        spec = spec.with_route(plan.route)
    kernel = resolve_kernel(spec, in_hw=(in_shape[1], in_shape[2]))
    if kernel.startswith("cuda"):
        lrn_p, pool = _spec_fusion(spec)
        p = _kernel_weight_plan(spec, kernel, tuple(in_shape),
                                tuple(w.shape), lrn=lrn_p, pool=pool,
                                knobs=knobs, abft=abft)
        data = _pack_for_plan(kernel, w, p, bfp_pack)
        kernel_tile(kernel, p, knobs, data.dtype)
    else:
        data = _quantize_filters(w) if bfp_pack else None
    ctx = pack_context(spec, kernel, bfp_pack=bfp_pack, abft=abft,
                       knobs=knobs)
    return PackedConvWeights(
        kernel=kernel, data=data, bfp=bfp_pack,
        fingerprint=slab_fingerprint(data, ctx) if fingerprint else None)


def dispatch_conv(spec: ConvSpec, x, w, b=None, *,
                  w_packed: PackedConvWeights | None = None,
                  plan: ConvPlan | None = None, weight_prefetch=UNSET,
                  k_block=UNSET, batch_block=UNSET, c_block=UNSET,
                  pool_row_block=UNSET, row_parallel=UNSET,
                  abft: bool = False, verdict=None, prefetch_next=None):
    """Run one conv layer per its spec.  x (B,H,W,C), w (k,k,C//g,K), b (K,).

    ``w_packed`` is a slab staged by :func:`pack_conv_weights`, used when it
    matches the datapath and plan this call resolves to.  On a mismatch
    (another input shape or plan, a deferred bias, a route fallback) a
    ``bfp`` slab is repacked quantized for the actual call, so §3.6
    quantization is never dropped, and a plain slab is ignored (the kernel
    packs now — identical values).  The plan's tile picks the CUDA
    kernel's GEMM block tile (same bits).  ``prefetch_next`` is a zero-arg
    callable invoked right after the conv is issued: work it enqueues
    (packing layer N+1's slab) queues behind this layer on the stream.

    ``abft=True`` runs the kernels' armed variant and returns ``(y,
    verdict)`` on every route: the kernels add their count of mismatched
    checksum lanes to ``verdict`` (an int32 0-dim tensor, a fresh zero when
    None, so a forward can sum its layers into one); the routes without a
    slab leave it as it is.  ``y`` is bit-equal to the unarmed call's.

    The CUDA kernels have no backward: with grad mode on, a call that
    resolves to one with an input that requires grad raises, rather than
    return an output that silently carries no gradient.
    """
    assert w.shape[0] == w.shape[1] == spec.kernel, (w.shape, spec.kernel)
    knobs = plan_knobs(plan, batch_block=batch_block, k_block=k_block,
                       c_block=c_block, pool_row_block=pool_row_block,
                       weight_prefetch=weight_prefetch,
                       row_parallel=row_parallel)
    if plan is not None and plan.route is not None:
        spec = spec.with_route(plan.route)
    # an unfused bias sits between conv and ReLU, so every later stage is
    # deferred with it (conv -> +b -> relu -> lrn -> pool)
    defer_bias = b is not None and not spec.fuse_bias
    bias = b if spec.fuse_bias else None
    relu = spec.relu and not defer_bias
    lrn_p = spec.lrn if spec.fuse_lrn and not defer_bias else None
    pool = ((spec.pool_window, spec.pool_stride)
            if spec.fuse_pool and not defer_bias else None)
    kernel = resolve_kernel(spec, in_hw=(x.shape[1], x.shape[2]))
    if kernel.startswith("cuda") and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        raise ValueError(f"dispatch_conv: {kernel} (route 'pallas') has no "
                         f"backward; differentiate on route 'winograd' or "
                         f"'direct'")

    slab = None
    if w_packed is not None and kernel.startswith("cuda"):
        p = _kernel_weight_plan(spec, kernel, tuple(x.shape),
                                tuple(w.shape), lrn=lrn_p, pool=pool,
                                knobs=knobs, abft=abft)
        want = (p.weights.n_tiles, *p.weights.tile_shape)
        if (w_packed.kernel == kernel and w_packed.data is not None
                and tuple(w_packed.data.shape) == want):
            slab = w_packed.data
        elif w_packed.bfp:
            slab = _pack_for_plan(kernel, w, p, True)
    elif w_packed is not None:
        if w_packed.kernel == kernel and w_packed.data is not None:
            w = w_packed.data       # BFP-quantized raw filters
        elif w_packed.bfp:          # route fell back with a stale slab
            w = _quantize_filters(w)

    kw = dict(c_block=knobs.c_block, pool_row_block=knobs.pool_row_block,
              k_block=knobs.k_block, batch_block=knobs.batch_block,
              weight_prefetch=knobs.weight_prefetch, checksum=abft,
              verdict=verdict)
    tile = dict(tile_rows=knobs.tile_rows, tile_cols=knobs.tile_cols)
    if abft and not kernel.startswith("cuda"):
        verdict = new_verdict(x, verdict)
    if kernel == "direct":
        y = conv2d_ref(x, w, bias, stride=spec.stride, padding=spec.padding,
                       groups=spec.groups, relu=relu, lrn=lrn_p, pool=pool)
    elif kernel == "cuda-winograd":
        y = kernel_conv2d(x, w, bias, slab, m=spec.winograd_m,
                          padding=spec.padding, relu=relu, groups=spec.groups,
                          lrn=lrn_p, pool=pool, **kw, **tile)
    elif kernel == "cuda-direct":
        y = kernel_conv2d_direct(x, w, bias, slab, stride=spec.stride,
                                 padding=spec.padding, relu=relu,
                                 groups=spec.groups, lrn=lrn_p, pool=pool,
                                 **kw, **tile)
    else:
        y = conv2d_winograd(x, w, bias, m=spec.winograd_m,
                            padding=spec.padding, relu=relu,
                            groups=spec.groups, lrn=lrn_p, pool=pool)
    if abft and kernel.startswith("cuda"):
        y, verdict = y
    if prefetch_next is not None:
        prefetch_next()             # stage layer N+1 behind this dispatch
    if defer_bias:
        y = y + b.to(y.dtype)
        if spec.relu:
            y = _relu(y)
        y = apply_epilogue(y, spec.lrn if spec.fuse_lrn else None,
                           (spec.pool_window, spec.pool_stride)
                           if spec.fuse_pool else None)
    return (y, verdict) if abft else y
