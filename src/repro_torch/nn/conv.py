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
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core.winograd import conv2d_winograd
from ..kernels.conv import direct as _direct_k
from ..kernels.conv import winograd as _winograd_k
from ..kernels.conv.ops import conv2d as kernel_conv2d
from ..kernels.conv.ops import conv2d_direct as kernel_conv2d_direct
from ..kernels.conv.ref import conv2d_ref
from .pooling import LrnParams, apply_epilogue, pooled_hw

ROUTES = ("auto", "direct", "winograd", "pallas")

# sentinel distinguishing "knob not passed" from an explicit None (= auto)
UNSET = object()


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclass(frozen=True)
class ConvPlan:
    """Per-layer launch knobs, the reference's fields and defaults.  On the
    port the blocking knobs shape only the packed slab, both
    ``weight_prefetch`` values launch the same CUDA kernels, and
    ``row_parallel`` must stay False (:func:`plan_knobs` refuses it)."""
    batch_block: int = 8
    k_block: int = 128
    c_block: int | None = None
    pool_row_block: int | None = None
    weight_prefetch: bool = True
    row_parallel: bool = False
    route: str | None = None

    def __post_init__(self):
        assert self.route is None or self.route in ROUTES, self.route
        assert self.batch_block >= 1 and self.k_block >= 1


DEFAULT_PLAN = ConvPlan()


def plan_knobs(plan: "ConvPlan | None" = None, *, batch_block=UNSET,
               k_block=UNSET, c_block=UNSET, pool_row_block=UNSET,
               weight_prefetch=UNSET, row_parallel=UNSET) -> "ConvPlan":
    """Effective knobs: explicit kwarg beats plan beats default."""
    base = plan if plan is not None else DEFAULT_PLAN
    kw = dict(batch_block=batch_block, k_block=k_block, c_block=c_block,
              pool_row_block=pool_row_block,
              weight_prefetch=weight_prefetch, row_parallel=row_parallel)
    knobs = replace(base, **{k: v for k, v in kw.items() if v is not UNSET})
    if knobs.row_parallel:
        _not_ported("row_parallel (the TPU's row-parallel weight stream)",
                    "ROADMAP Queue 1, item 5: the measured autotuner")
    return knobs


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


@dataclass(frozen=True)
class PackedConvWeights:
    """A staged weight slab: the resolved datapath it was packed for plus
    the packed tensor (None when the route has no packed form)."""
    kernel: str
    data: object


def _spec_fusion(spec: ConvSpec):
    lrn_p = spec.lrn if spec.fuse_lrn else None
    pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
    return lrn_p, pool


def _kernel_weight_plan(spec: ConvSpec, kernel: str, in_shape, w_shape, *,
                        lrn, pool, knobs: ConvPlan):
    """The plan of the resolved kernel — the one source of slab shapes."""
    if kernel == "cuda-winograd":
        return _winograd_k.plan(in_shape, w_shape, m=spec.winograd_m,
                                padding=spec.padding, groups=spec.groups,
                                lrn=lrn, pool=pool, c_block=knobs.c_block,
                                pool_row_block=knobs.pool_row_block,
                                k_block=knobs.k_block,
                                batch_block=knobs.batch_block)
    return _direct_k.plan(in_shape, w_shape, stride=spec.stride,
                          padding=spec.padding, pool=pool,
                          groups=spec.groups, c_block=knobs.c_block,
                          pool_row_block=knobs.pool_row_block,
                          k_block=knobs.k_block,
                          batch_block=knobs.batch_block)


def _pack_for_plan(kernel: str, w, p):
    pack = (_winograd_k.pack_weights if kernel == "cuda-winograd"
            else _direct_k.pack_weights)
    return pack(w, p)


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


def _check_unported(*, bfp_pack=False, abft=False, fingerprint=False):
    if bfp_pack:
        _not_ported("conv_bfp (BFP-quantized conv slabs)",
                    "ROADMAP Queue 1, item 2: conv_bfp/fc_bfp with kernel 4")
    if abft:
        _not_ported("ABFT (abft=True / sdc_abft)",
                    "ROADMAP Queue 1, item 1: ABFT/SDC in kernels 1-3")
    if fingerprint:
        _not_ported("slab fingerprints",
                    "ROADMAP Queue 1, item 1: ABFT/SDC in kernels 1-3")


def pack_conv_weights(spec: ConvSpec, in_shape, w, *, bfp_pack: bool = False,
                      abft: bool = False, fingerprint: bool = False,
                      plan: ConvPlan | None = None, k_block=UNSET,
                      batch_block=UNSET) -> PackedConvWeights:
    """Build the weight slab for one conv layer ahead of its input: a pure
    function of the spec, the input *shape* (B, H, W, C) and the filters
    (Winograd transform, group/channel blocking, tile layout)."""
    _check_unported(bfp_pack=bfp_pack, abft=abft, fingerprint=fingerprint)
    knobs = plan_knobs(plan, k_block=k_block, batch_block=batch_block)
    if plan is not None and plan.route is not None:
        spec = spec.with_route(plan.route)
    kernel = resolve_kernel(spec, in_hw=(in_shape[1], in_shape[2]))
    data = None
    if kernel.startswith("cuda"):
        lrn_p, pool = _spec_fusion(spec)
        p = _kernel_weight_plan(spec, kernel, tuple(in_shape),
                                tuple(w.shape), lrn=lrn_p, pool=pool,
                                knobs=knobs)
        data = _pack_for_plan(kernel, w, p)
    return PackedConvWeights(kernel=kernel, data=data)


def dispatch_conv(spec: ConvSpec, x, w, b=None, *,
                  w_packed: PackedConvWeights | None = None,
                  plan: ConvPlan | None = None, weight_prefetch=UNSET,
                  k_block=UNSET, batch_block=UNSET, c_block=UNSET,
                  pool_row_block=UNSET, row_parallel=UNSET,
                  abft: bool = False, prefetch_next=None):
    """Run one conv layer per its spec.  x (B,H,W,C), w (k,k,C//g,K), b (K,).

    ``w_packed`` is a slab staged by :func:`pack_conv_weights`, used when it
    matches the datapath and plan this call resolves to (otherwise the
    kernel packs now — identical values).  ``prefetch_next`` is a zero-arg
    callable invoked right after the conv is issued: work it enqueues
    (packing layer N+1's slab) queues behind this layer on the stream.
    """
    _check_unported(abft=abft)
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

    slab = None
    if w_packed is not None and kernel.startswith("cuda"):
        p = _kernel_weight_plan(spec, kernel, tuple(x.shape),
                                tuple(w.shape), lrn=lrn_p, pool=pool,
                                knobs=knobs)
        want = (p.weights.n_tiles, *p.weights.tile_shape)
        if (w_packed.kernel == kernel and w_packed.data is not None
                and tuple(w_packed.data.shape) == want):
            slab = w_packed.data

    kw = dict(c_block=knobs.c_block, pool_row_block=knobs.pool_row_block,
              k_block=knobs.k_block, batch_block=knobs.batch_block,
              weight_prefetch=knobs.weight_prefetch)
    if kernel == "direct":
        y = conv2d_ref(x, w, bias, stride=spec.stride, padding=spec.padding,
                       groups=spec.groups, relu=relu, lrn=lrn_p, pool=pool)
    elif kernel == "cuda-winograd":
        y = kernel_conv2d(x, w, bias, slab, m=spec.winograd_m,
                          padding=spec.padding, relu=relu, groups=spec.groups,
                          lrn=lrn_p, pool=pool, **kw)
    elif kernel == "cuda-direct":
        y = kernel_conv2d_direct(x, w, bias, slab, stride=spec.stride,
                                 padding=spec.padding, relu=relu,
                                 groups=spec.groups, lrn=lrn_p, pool=pool,
                                 **kw)
    else:
        y = conv2d_winograd(x, w, bias, m=spec.winograd_m,
                            padding=spec.padding, relu=relu,
                            groups=spec.groups, lrn=lrn_p, pool=pool)
    if prefetch_next is not None:
        prefetch_next()             # stage layer N+1 behind this dispatch
    if defer_bias:
        y = y + b.to(y.dtype)
        if spec.relu:
            y = torch.clamp_min(y, 0)
        y = apply_epilogue(y, spec.lrn if spec.fuse_lrn else None,
                           (spec.pool_window, spec.pool_stride)
                           if spec.fuse_pool else None)
    return y
