"""AlexNet — the paper's benchmark network — and VGG-16 (the reference's
``repro/models/alexnet.py``).

Each conv layer, LRN and pool included, is one :class:`ConvSpec` through
:func:`dispatch_conv`; under ``use_pallas`` AlexNet's conv1/conv2 run the
CUDA direct kernel and conv3-conv5 the CUDA Winograd kernels, and all
thirteen of VGG-16's 3x3 convs (``arch="vgg"``) the Winograd kernels, the
five that close a stage with a fused 2x2/2 max-pool.  Activations are NHWC
and filters HWIO at every public function, as in the reference, and the
last conv's output is flattened in NHWC order before fc6.

``dtype="bfloat16"`` is the reference's bf16 model: parameters and
activations in bf16, the conv kernels f32 inside with one rounding of
each layer's output, the FC layers in bf16 (under ``fc_bfp`` the BFP
matmul on the activations taken as f32, the f32 bias added, then one
rounding to bf16, as the reference does).  Parameters cross the numpy
boundary as float32 arrays (exact for bf16 values), so no bf16 numpy type
is needed.

§3.6 block floating point: ``conv_bfp`` quantizes the staged conv slabs
(the kernels then read BFP-quantized filters, dequantized to f32 in a
bf16 model too, as in the reference), and ``fc_bfp`` runs fc6-fc8
through the BFP matmul kernel (``csrc/bfp_matmul.cu``) on int8 weight
streams, whatever the conv route.

SDC defense: ``sdc_abft`` packs every conv slab with its ABFT checksum
rows and runs the kernels' armed variant; the forward then returns
``(logits, sdc)``, ``sdc`` an int32 device tensor that every layer adds
its mismatched checksum lanes to (0: every slab intact).  It costs one
zero-fill a forward and no host sync.

Training: :func:`loss_fn` is differentiable on the routes the reference
differentiates, ``winograd`` (``core/winograd.py``'s plain Winograd, and
``conv2d_ref`` on the layers it does not take) and ``direct``, in f32 and
bf16 and under ``conv_bfp``, whose filters go through ``round`` and get a
zero gradient, as in the reference.  A forward with grad mode on and a
parameter that requires grad packs every slab from the live weights, and
raises where the reference's gradient fails too: on route ``pallas`` and
under ``fc_bfp`` the kernel's entry refuses (``dispatch_conv``,
``bfp_matmul``: the CUDA kernels have no backward), under ``sdc_abft``
:func:`features`.
Serving callers hold parameters that do not require grad, or run under
``torch.no_grad()``: their forward builds no graph.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.bfp_matmul.ops import bfp_linear, fc_block, quantize_weights
from ..kernels.conv.dma import WeightStager
from ..nn.conv import ConvSpec, dispatch_conv, expected_pack_context, \
    pack_conv_weights, resolve_kernel
from ..nn.module import truncated_normal
from ..nn.pooling import LrnParams


@dataclass(frozen=True)
class AlexNetConfig:
    """CNN model config; the reference's fields and defaults, so one config
    means the same in both packages."""
    name: str = "alexnet"
    family: str = "cnn"
    arch: str = "alexnet"
    image_size: int = 227
    in_channels: int = 3
    conv_channels: Tuple[int, ...] = (96, 256, 384, 384, 256)
    pool_after: Tuple[int, ...] = ()
    fc_dims: Tuple[int, ...] = (4096, 4096, 1000)
    num_classes: int = 1000
    use_winograd: bool = True      # F(4,3) on the 3x3 stride-1 layers
    use_pallas: bool = False       # hand-written kernels (CUDA here)
    fc_batch: int = 96
    fc_bfp: bool = False
    conv_bfp: bool = False
    weight_prefetch: bool = True   # same kernel either way on the port
    sdc_abft: bool = False         # ABFT checksum rows on the conv slabs;
                                   # the forward returns (logits, sdc)
    lrn_n: int = 5
    lrn_k: float = 2.0
    lrn_alpha: float = 1e-4
    lrn_beta: float = 0.75
    dtype: str = "float32"

    def reduced(self) -> "AlexNetConfig":
        if self.arch == "vgg":
            return replace(self, image_size=32, conv_channels=(8, 16, 16, 24),
                           pool_after=(1, 2, 4), fc_dims=(32, 24, 10),
                           num_classes=10, fc_batch=4)
        return replace(self, image_size=67, conv_channels=(16, 32, 48, 48, 32),
                       fc_dims=(64, 48, 10), num_classes=10, fc_batch=4)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: AlexNetConfig):
    """Raise for a config the reference rejects too."""
    if cfg.arch not in ("alexnet", "vgg"):
        raise ValueError(f"unknown CNN arch {cfg.arch!r}; the reference's "
                         f"are 'alexnet' and 'vgg'")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; the CNN path "
                         f"takes {list(DTYPES)}")


def _needs_grad(params) -> bool:
    return torch.is_grad_enabled() and any(
        v.requires_grad for sub in params.values() for v in sub.values())


def layer_specs(cfg: AlexNetConfig) -> List[ConvSpec]:
    """Krizhevsky geometry: conv1/conv2 carry LRN + pool, conv5 pool only,
    every conv fuses bias+ReLU.  ``arch="vgg"``: every layer a 3x3 stride-1
    SAME conv with bias+ReLU, a fused 2x2/2 max-pool after each layer in
    ``cfg.pool_after`` (1-based), no LRN."""
    check_supported(cfg)
    if cfg.arch == "vgg":
        return [ConvSpec(kernel=3, relu=True,
                         fuse_pool=(i + 1) in cfg.pool_after,
                         pool_window=2, pool_stride=2)
                for i in range(len(cfg.conv_channels))]
    lrn = LrnParams(n=cfg.lrn_n, k=cfg.lrn_k, alpha=cfg.lrn_alpha,
                    beta=cfg.lrn_beta)
    return [
        ConvSpec(kernel=11, stride=4, padding="VALID", relu=True,
                 fuse_lrn=True, lrn=lrn, fuse_pool=True),
        ConvSpec(kernel=5, groups=2, relu=True,
                 fuse_lrn=True, lrn=lrn, fuse_pool=True),
        ConvSpec(kernel=3, relu=True),
        ConvSpec(kernel=3, groups=2, relu=True),
        ConvSpec(kernel=3, groups=2, relu=True, fuse_pool=True),
    ]


def _route(cfg: AlexNetConfig) -> str:
    if not cfg.use_winograd:
        return "direct"
    return "pallas" if cfg.use_pallas else "winograd"


def layer_routes(cfg: AlexNetConfig) -> List[Tuple[str, str]]:
    """(layer name, resolved datapath) per conv layer, shape-aware."""
    route = _route(cfg)
    routes = []
    h = cfg.image_size
    for i, spec in enumerate(layer_specs(cfg)):
        routes.append((f"conv{i + 1}",
                       resolve_kernel(spec.with_route(route), in_hw=h)))
        h = spec.out_hw(h)
    return routes


def init(seed_or_generator, cfg: AlexNetConfig, *, device="cuda") -> dict:
    """Random parameters: truncated normal, std (k*k*C/g)^-0.5 for convs
    and fan_in^-0.5 for FC layers, zero biases (the reference's scheme; the
    numbers differ from its ``jax.random`` draw).  Drawn in float32 on the
    host from a ``torch.Generator`` (or an int seed), rounded to the
    config's dtype, then moved to ``device``."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    return {name: {"w": truncated_normal(gen, shape, std).to(dev, dtype),
                   "b": torch.zeros((width,), device=dev, dtype=dtype)}
            for name, shape, std, width in _param_table(cfg)}


def empty_params(cfg: AlexNetConfig, *, device="cuda") -> dict:
    """Uninitialized parameters of :func:`init`'s structure, shapes and
    dtype on ``device``: what a checkpoint restores into, without the
    host-side draw."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    return {name: {"w": torch.empty(shape, device=dev, dtype=dtype),
                   "b": torch.empty((width,), device=dev, dtype=dtype)}
            for name, shape, std, width in _param_table(cfg)}


def _param_table(cfg: AlexNetConfig):
    """(layer, weight shape, weight std, bias width) in draw order."""
    c_in = cfg.in_channels
    for i, (spec, c_out) in enumerate(zip(layer_specs(cfg),
                                          cfg.conv_channels)):
        k, g = spec.kernel, spec.groups
        yield (f"conv{i+1}", (k, k, c_in // g, c_out),
               (k * k * c_in // g) ** -0.5, c_out)
        c_in = c_out
    d_in = fc_input_dim(cfg)
    for j, d_out in enumerate(cfg.fc_dims):
        yield f"fc{j+6}", (d_in, d_out), d_in ** -0.5, d_out
        d_in = d_out


def params_from_numpy(np_params, device="cuda", dtype="float32") -> dict:
    """Carry the reference's parameters (``repro.models.alexnet.init``'s
    pytree, as numpy arrays) into the port's params dict on ``device`` in
    ``dtype`` (the config's).  Each array is read as float32 first, which
    holds a bf16 value exactly, then rounded to ``dtype``."""
    dev = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                    device=dev).to(DTYPES[dtype])
                    for k, v in sub.items()}
            for layer, sub in np_params.items()}


def params_to_numpy(params) -> dict:
    """The params as numpy arrays on the host; bf16 tensors as float32
    (exact), since numpy has no bf16 type of its own."""
    return {layer: {k: (v.detach().float() if v.dtype == torch.bfloat16
                        else v.detach()).cpu().numpy()
                    for k, v in sub.items()}
            for layer, sub in params.items()}


def _feature_hw(cfg: AlexNetConfig) -> int:
    h = cfg.image_size
    for spec in layer_specs(cfg):
        h = spec.out_hw(h)
    return h


def fc_input_dim(cfg: AlexNetConfig) -> int:
    return _feature_hw(cfg) ** 2 * cfg.conv_channels[-1]


def _stage_fc(params, name: str):
    """The §3.6 quantized weight stream of one FC layer (``"fc6"``..), as
    :func:`bfp_linear` resolves its exponent block."""
    w = params[name]["w"]
    return quantize_weights(w, block=fc_block(w.shape[0]))


def load_tuned_plans(cfg: AlexNetConfig, batch: int, *, path=None,
                     device="cuda") -> dict:
    """Tuned per-layer :class:`~repro_torch.nn.conv.ConvPlan`s from the
    measured autotuner's cache (by default the port's own
    ``results/plans/alexnet_torch.json``), keyed to this config's layer
    geometries at ``batch`` on ``device``'s backend kind: ``{}`` when
    nothing applies, and the layers run the default plan.  Every tuned
    plan gives the default plan's bits.  See ``core/autotune.py`` and
    ``scripts/autotune_alexnet_torch.py``."""
    from ..core.autotune import load_alexnet_plans
    return load_alexnet_plans(cfg, batch, path=path, device=device)


def pack_serving_slabs(params, cfg: AlexNetConfig, batch: int, *,
                       plans=None, fingerprint: bool = False,
                       stager=None) -> dict:
    """Pack-once serving slabs for one batch shape: every conv layer's
    :class:`~repro_torch.nn.conv.PackedConvWeights` (BFP-quantized under
    ``cfg.conv_bfp``), plus, under ``cfg.fc_bfp``, the quantized streams of
    fc6, fc7 and fc8.  The reference stages fc6 only and quantizes fc7/fc8
    inside its compiled forward; the eager port stages all three so no
    batch repeats that pass (same values either way).  The FC streams do
    not depend on the batch, so they come from ``stager`` (a
    :class:`WeightStager` bound to ``params``) under ``"fc6"``..: one copy
    for every batch shape packed with the same stager.  ``cfg.sdc_abft``
    packs each conv slab with its checksum rows; ``fingerprint`` stamps
    each with a :class:`~repro_torch.nn.conv.SlabFingerprint` (a host copy
    of every slab) for the engine's pre-dispatch check."""
    check_supported(cfg)
    plans = plans or {}
    route = _route(cfg)
    specs = [s.with_route(route) for s in layer_specs(cfg)]
    packed = {}
    h, c_in = cfg.image_size, cfg.in_channels
    for i, (spec, c_out) in enumerate(zip(specs, cfg.conv_channels)):
        name = f"conv{i + 1}"
        packed[name] = pack_conv_weights(
            spec, (batch, h, h, c_in), params[name]["w"],
            bfp_pack=cfg.conv_bfp, abft=cfg.sdc_abft,
            fingerprint=fingerprint, plan=plans.get(name))
        h, c_in = spec.out_hw(h), c_out
    if cfg.fc_bfp:
        stager = WeightStager() if stager is None else stager
        for j in range(len(cfg.fc_dims)):
            name = f"fc{j + 6}"
            packed[name] = stager.stage(name, _stage_fc, params, name)
    return packed


def features(params, cfg: AlexNetConfig, images, *, stager=None, plans=None,
             packed=None):
    """images (B, H, W, 3) NHWC -> flattened conv features (B, d), NHWC
    order.  One ``dispatch_conv`` per layer; each layer's
    ``prefetch_next`` hook packs layer N+1's slab right after layer N is
    issued (queued behind it on the stream), and conv5's hook stages fc6's
    quantized stream under ``cfg.fc_bfp``.  ``packed`` is a
    :func:`pack_serving_slabs` dict: layers use it and skip the staging.

    Under ``cfg.sdc_abft`` the return is ``(features, sdc)``: one int32
    zero on the device that every layer's kernel adds its mismatched
    checksum lanes to.  A verifying stager (``WeightStager(verify=True)``)
    gets fingerprinted slabs and the pack context to expect on a hit.

    A differentiable forward (grad mode on, a parameter that requires
    grad) packs from the live weights: it refuses ``packed`` and a stager
    that already holds slabs, which were packed from the weights of an
    earlier step.  It refuses ``sdc_abft``: the armed forward returns
    ``(logits, sdc)``, which the reference's ``loss_fn`` does not take
    apart, and its checksums guard served slabs."""
    check_supported(cfg)
    if _needs_grad(params):
        if cfg.sdc_abft:
            raise ValueError(
                "alexnet: no gradient under sdc_abft: the armed forward "
                "returns (logits, sdc) and its checksums guard served "
                "slabs; train with sdc_abft=False")
        if packed is not None or (stager is not None and stager.misses):
            raise ValueError(
                "alexnet.features: a differentiable forward packs every "
                "slab from the live weights; pass no packed slabs and no "
                "stager that has staged any")
    x = images.to(DTYPES[cfg.dtype])
    route = _route(cfg)
    plans = plans or {}
    specs = [s.with_route(route) for s in layer_specs(cfg)]
    abft = cfg.sdc_abft
    sdc = (torch.zeros((), dtype=torch.int32, device=x.device) if abft
           else None)

    def done(x):
        flat = x.reshape(x.shape[0], -1)
        return (flat, sdc) if abft else flat

    def kw(i):
        plan = plans.get(f"conv{i + 1}")
        return ({"plan": plan} if plan is not None
                else {"weight_prefetch": cfg.weight_prefetch})

    def conv(i, x, w_packed, prefetch_next=None):
        p = params[f"conv{i + 1}"]
        y = dispatch_conv(specs[i], x, p["w"], p["b"], w_packed=w_packed,
                          abft=abft, verdict=sdc,
                          prefetch_next=prefetch_next, **kw(i))
        return y[0] if abft else y

    if packed is not None:
        for i in range(len(specs)):
            x = conv(i, x, packed.get(f"conv{i + 1}"))
        return done(x)

    stager = WeightStager() if stager is None else stager
    B, shapes, h, c_in = x.shape[0], [], x.shape[1], cfg.in_channels
    for spec, c_out in zip(specs, cfg.conv_channels):
        shapes.append((B, h, h, c_in))
        h, c_in = spec.out_hw(h), c_out

    def stage(i):
        # the slab depends on the layer's input shape, its quantization and
        # its plan, so a stager shared by configs never serves a slab of
        # another quantization
        plan = plans.get(f"conv{i + 1}")
        key = (f"conv{i + 1}:{shapes[i]}:{x.device}:bfp{int(cfg.conv_bfp)}"
               f":abft{int(abft)}"
               + (f":plan{plan}" if plan is not None else ""))
        verify = stager.verify
        expect = (expected_pack_context(specs[i], shapes[i],
                                        bfp_pack=cfg.conv_bfp, abft=abft,
                                        plan=plan) if verify else None)
        return stager.stage(key, pack_conv_weights, specs[i], shapes[i],
                            params[f"conv{i + 1}"]["w"],
                            bfp_pack=cfg.conv_bfp, abft=abft,
                            fingerprint=verify, plan=plan, expect=expect)

    def stage_fc():
        stager.stage("fc6", _stage_fc, params, "fc6")

    for i in range(len(specs)):
        nxt = ((lambda i=i: stage(i + 1)) if i + 1 < len(specs)
               else (stage_fc if cfg.fc_bfp else None))
        x = conv(i, x, stage(i), nxt)
    return done(x)


def classifier(params, cfg: AlexNetConfig, feats, *, stager=None,
               packed=None):
    """FC layers fc6-fc8 with ReLU between: plain ``x @ w + b`` (the
    reference leaves them to XLA), or under ``cfg.fc_bfp`` the BFP matmul
    kernel on each layer's int8 weight stream (§3.6), plus the bias in
    f32, rounded to the activations' dtype, as the reference does.  A
    layer's stream comes from ``packed`` (:func:`pack_serving_slabs`), else
    from the ``stager`` (fc6, staged by conv5's hook), else is quantized
    now — the same values each way."""
    check_supported(cfg)
    x = feats
    n_fc = len(cfg.fc_dims)
    for j in range(n_fc):
        name = f"fc{j + 6}"
        p = params[name]
        if cfg.fc_bfp:
            source = packed if packed is not None else stager
            q = source.get(name) if source is not None else None
            x = (bfp_linear(x, p["w"], quantized=q)
                 + p["b"].float()).to(x.dtype)
        else:
            x = x @ p["w"] + p["b"]
        if j < n_fc - 1:
            x = torch.relu(x)
    return x


def apply(params, cfg: AlexNetConfig, images, *, stager=None, plans=None,
          packed=None):
    """Full forward: images (B, H, W, C) -> logits (B, num_classes), or
    ``(logits, sdc)`` under ``cfg.sdc_abft``.  One stager spans conv and
    FC, so conv5's hook can stage fc6's stream.  Differentiable on routes
    ``winograd`` and ``direct``; params that do not require grad (or
    ``torch.no_grad()``) build no graph."""
    stager = WeightStager() if stager is None else stager
    feats = features(params, cfg, images, stager=stager, plans=plans,
                     packed=packed)
    if cfg.sdc_abft:
        feats, sdc = feats
        return classifier(params, cfg, feats, stager=stager,
                          packed=packed), sdc
    return classifier(params, cfg, feats, stager=stager, packed=packed)


def loss_fn(params, cfg: AlexNetConfig, batch):
    """(loss, {"loss", "accuracy"}) for a batch of images and int labels;
    the loss carries the gradient of every parameter that requires grad
    (``torch.autograd.grad(loss, leaves)``), packed from the live weights
    on every call."""
    logits = apply(params, cfg, batch["images"])
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
