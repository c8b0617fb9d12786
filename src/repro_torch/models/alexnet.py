"""AlexNet — the paper's benchmark network (the reference's
``repro/models/alexnet.py``).

Each conv layer, LRN and pool included, is one :class:`ConvSpec` through
:func:`dispatch_conv`; under ``use_pallas`` conv1/conv2 run the CUDA direct
kernel and conv3-conv5 the CUDA Winograd kernels.  Activations are NHWC and
filters HWIO at every public function, as in the reference, and the conv5
output is flattened in NHWC order before fc6.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.conv.dma import WeightStager
from ..nn.conv import ConvSpec, dispatch_conv, pack_conv_weights, \
    resolve_kernel
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
    sdc_abft: bool = False
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


def check_supported(cfg: AlexNetConfig):
    """Raise for the config features later slices port."""
    if cfg.arch != "alexnet":
        raise NotImplementedError("arch='vgg' is not ported yet (ROADMAP "
                                  "Queue 1, item 3: VGG-16 and the registry)")
    if cfg.fc_bfp or cfg.conv_bfp:
        raise NotImplementedError("fc_bfp/conv_bfp are not ported yet "
                                  "(ROADMAP Queue 1, item 2: kernel 4)")
    if cfg.sdc_abft:
        raise NotImplementedError("sdc_abft is not ported yet (ROADMAP "
                                  "Queue 1, item 1: ABFT/SDC in kernels 1-3)")
    if cfg.dtype != "float32":
        raise NotImplementedError("the port serves float32 only")


def layer_specs(cfg: AlexNetConfig) -> List[ConvSpec]:
    """Krizhevsky geometry: conv1/conv2 carry LRN + pool, conv5 pool only,
    every conv fuses bias+ReLU."""
    check_supported(cfg)
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


def _truncated_normal(gen, shape, scale):
    # 2-sigma truncation, as the reference's nn/module.py:truncated_normal
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * scale


def init(seed_or_generator, cfg: AlexNetConfig, *, device="cuda") -> dict:
    """Random parameters: truncated normal, std (k*k*C/g)^-0.5 for convs
    and fan_in^-0.5 for FC layers, zero biases (the reference's scheme; the
    numbers differ from its ``jax.random`` draw).  Drawn on the host from a
    ``torch.Generator`` (or an int seed), then moved to ``device``."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    p = {}
    c_in = cfg.in_channels
    for i, (spec, c_out) in enumerate(zip(layer_specs(cfg),
                                          cfg.conv_channels)):
        k, g = spec.kernel, spec.groups
        p[f"conv{i+1}"] = {
            "w": _truncated_normal(gen, (k, k, c_in // g, c_out),
                                   (k * k * c_in // g) ** -0.5).to(dev),
            "b": torch.zeros((c_out,), device=dev),
        }
        c_in = c_out
    d_in = fc_input_dim(cfg)
    for j, d_out in enumerate(cfg.fc_dims):
        p[f"fc{j+6}"] = {
            "w": _truncated_normal(gen, (d_in, d_out), d_in ** -0.5).to(dev),
            "b": torch.zeros((d_out,), device=dev),
        }
        d_in = d_out
    return p


def params_from_numpy(np_params, device="cuda") -> dict:
    """Carry the reference's parameters (``repro.models.alexnet.init``'s
    pytree, as numpy arrays) into the port's params dict on ``device``."""
    dev = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                    device=dev)
                    for k, v in sub.items()}
            for layer, sub in np_params.items()}


def params_to_numpy(params) -> dict:
    return {layer: {k: v.detach().cpu().numpy() for k, v in sub.items()}
            for layer, sub in params.items()}


def _feature_hw(cfg: AlexNetConfig) -> int:
    h = cfg.image_size
    for spec in layer_specs(cfg):
        h = spec.out_hw(h)
    return h


def fc_input_dim(cfg: AlexNetConfig) -> int:
    return _feature_hw(cfg) ** 2 * cfg.conv_channels[-1]


def load_tuned_plans(cfg: AlexNetConfig, batch: int, *, path=None) -> dict:
    """Tuned per-layer plans: none yet, so every layer runs the default
    :class:`~repro_torch.nn.conv.ConvPlan` (``{}``).  Plans tuned for the
    TPU kernels do not apply to the CUDA kernels, and a plan cache is
    refused rather than ignored until the port's own measured autotuner
    exists (ROADMAP Queue 1, item 5)."""
    if path is not None:
        raise NotImplementedError("tuned plans are not ported yet (ROADMAP "
                                  "Queue 1, item 5: the measured autotuner)")
    return {}


def pack_serving_slabs(params, cfg: AlexNetConfig, batch: int, *,
                       plans=None, fingerprint: bool = False) -> dict:
    """Pack-once serving slabs for one batch shape: every conv layer's
    :class:`~repro_torch.nn.conv.PackedConvWeights`."""
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
            fingerprint=fingerprint, plan=plans.get(name))
        h, c_in = spec.out_hw(h), c_out
    return packed


def features(params, cfg: AlexNetConfig, images, *, stager=None, plans=None,
             packed=None):
    """images (B, H, W, 3) NHWC -> flattened conv features (B, d), NHWC
    order.  One ``dispatch_conv`` per layer; each layer's
    ``prefetch_next`` hook packs layer N+1's slab right after layer N is
    issued (queued behind it on the stream).  ``packed`` is a
    :func:`pack_serving_slabs` dict: layers use it and skip the staging."""
    check_supported(cfg)
    x = images.to(torch.float32)
    route = _route(cfg)
    plans = plans or {}
    specs = [s.with_route(route) for s in layer_specs(cfg)]

    def kw(i):
        plan = plans.get(f"conv{i + 1}")
        return ({"plan": plan} if plan is not None
                else {"weight_prefetch": cfg.weight_prefetch})

    if packed is not None:
        for i, spec in enumerate(specs):
            p = params[f"conv{i + 1}"]
            x = dispatch_conv(spec, x, p["w"], p["b"],
                              w_packed=packed.get(f"conv{i + 1}"), **kw(i))
        return x.reshape(x.shape[0], -1)

    stager = WeightStager() if stager is None else stager
    B, shapes, h, c_in = x.shape[0], [], x.shape[1], cfg.in_channels
    for spec, c_out in zip(specs, cfg.conv_channels):
        shapes.append((B, h, h, c_in))
        h, c_in = spec.out_hw(h), c_out

    def stage(i):
        # the slab depends on the layer's input shape and its plan
        plan = plans.get(f"conv{i + 1}")
        key = (f"conv{i + 1}:{shapes[i]}:{x.device}"
               + (f":plan{plan}" if plan is not None else ""))
        return stager.stage(key, pack_conv_weights, specs[i], shapes[i],
                            params[f"conv{i + 1}"]["w"], plan=plan)

    for i, spec in enumerate(specs):
        p = params[f"conv{i + 1}"]
        nxt = (lambda i=i: stage(i + 1)) if i + 1 < len(specs) else None
        x = dispatch_conv(spec, x, p["w"], p["b"], w_packed=stage(i),
                          prefetch_next=nxt, **kw(i))
    return x.reshape(x.shape[0], -1)


def classifier(params, cfg: AlexNetConfig, feats):
    """FC layers fc6-fc8: plain ``x @ w + b`` with ReLU between (the
    reference leaves them to XLA when ``fc_bfp`` is off)."""
    check_supported(cfg)
    x = feats
    n_fc = len(cfg.fc_dims)
    for j in range(n_fc):
        p = params[f"fc{j+6}"]
        x = x @ p["w"] + p["b"]
        if j < n_fc - 1:
            x = torch.relu(x)
    return x


@torch.no_grad()
def apply(params, cfg: AlexNetConfig, images, *, stager=None, plans=None,
          packed=None):
    """Full forward: images (B, H, W, C) -> logits (B, num_classes)."""
    feats = features(params, cfg, images, stager=stager, plans=plans,
                     packed=packed)
    return classifier(params, cfg, feats)


def loss_fn(params, cfg: AlexNetConfig, batch):
    """(loss, {"loss", "accuracy"}) for a batch of images and int labels."""
    logits = apply(params, cfg, batch["images"])
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
