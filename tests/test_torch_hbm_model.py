"""The per-layer traffic and work model of the PyTorch port
(``repro_torch.core.winograd.conv2d_hbm_bytes`` / ``conv_flops``, the
conv rooflines of ``core/roofline.py``, ``nn.conv.MODEL_ROUTES``,
``conv2d_direct``) against the JAX package's, on the CPU, and
``chip_smoke.py``'s use of it.

The traffic model is integer arithmetic in Python: over AlexNet's five
layers and ``tests/test_vgg_geometry.py``'s VGG-16 geometries, every
route, fusion flag, prefetch and row-parallel setting, batch, element
size and a few explicit blocks, every key must equal the reference's
with ``==``.  The rooflines at the reference's constants must match its
``to_json`` within 1e-12 relative; ``conv2d_direct`` (an f32 oracle, sums
in another order) the reference's within 1e-5 of max|y|.  Inputs are
made with numpy from a seed.
"""
import dataclasses
import importlib.util
import io
import itertools
import math
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)
from test_vgg_geometry import VGG16_LAYERS, VGG16_POOLED  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import roofline as j_roofline  # noqa: E402
from repro.core import winograd as j_wg  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro.nn import conv as j_conv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core import winograd as t_wg  # noqa: E402
from repro_torch.core.roofline import H100_SXM  # noqa: E402
from repro_torch.core.winograd import conv2d_hbm_bytes, conv_flops  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_HW = dataclasses.replace(
    H100_SXM, name="reference", peak_bf16=j_roofline.PEAK_FLOPS_BF16,
    hbm_bw=j_roofline.HBM_BW, link_bw=j_roofline.ICI_BW)
# the reference's datapath names -> the port's
KERNEL_NAMES = {"pallas-winograd": "cuda-winograd",
                "pallas-direct": "cuda-direct",
                "winograd": "winograd", "direct": "direct"}


def _alexnet_geometries():
    """(name, H, C, K, r, stride, padding, groups, relu, lrn, pool,
    pool_window, pool_stride) of AlexNet's five layers at 227 px."""
    cfg = get_config("alexnet")
    h, c_in, out = cfg.image_size, cfg.in_channels, []
    for i, (s, c_out) in enumerate(zip(alexnet.layer_specs(cfg),
                                       cfg.conv_channels)):
        out.append((f"alexnet-conv{i + 1}", h, c_in, c_out, s.kernel,
                    s.stride, s.padding, s.groups, s.relu, s.fuse_lrn,
                    s.fuse_pool, s.pool_window, s.pool_stride))
        h, c_in = s.out_hw(h), c_out
    return out


def _vgg_geometries():
    """VGG-16's 13 layers; a layer is pooled (2x2/2) where the extent
    halves after it, which is ``VGG16_POOLED``."""
    out = []
    for i, (h, c_in, c_out) in enumerate(VGG16_LAYERS):
        last = i + 1 == len(VGG16_LAYERS) or VGG16_LAYERS[i + 1][0] != h
        out.append((f"vgg16-{i + 1}", h, c_in, c_out, 3, 1, "SAME", 1, True,
                    False, last, 2, 2))
    assert [(g[1], g[3]) for g in out if g[10]] == VGG16_POOLED
    return out


GEOMETRIES = _alexnet_geometries() + _vgg_geometries()
BLOCKS = ({"c_block": None, "k_block": 128, "pool_row_block": None,
           "batch_block": 8},
          {"c_block": 16, "k_block": 32, "pool_row_block": 2,
           "batch_block": 4},
          {"c_block": 64, "k_block": 64, "pool_row_block": None,
           "batch_block": 1})


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_hbm_bytes_and_flops_equal_the_reference(geom):
    (_, H, C, K, r, stride, padding, groups, relu, lrn, pool, pwin,
     pstride) = geom
    eligible = r == 3 and stride == 1
    out_hw = t_conv.conv_out_hw(H, r, stride, padding)
    fusions = {(relu, lrn, pool), (False, False, False)}
    if out_hw >= pwin:
        fusions.add((True, True, True))
    n = 0
    for m in [None] + ([2, 4, 6] if eligible else []):
        assert conv_flops(out_hw, out_hw, C // groups, K, r, m) == \
            j_wg.conv_flops(out_hw, out_hw, C // groups, K, r, m)
        for (route, (f_relu, f_lrn, f_pool), prefetch, row_par, B,
             dtype_bytes, blocks) in itertools.product(
                ("pallas", "winograd", "direct"), sorted(fusions),
                (True, False), (False, True), (1, 8), (2, 4), BLOCKS):
            kw = dict(dtype_bytes=dtype_bytes, padding=padding,
                      stride=stride, relu=f_relu, fuse_lrn=f_lrn,
                      fuse_pool=f_pool, pool_window=pwin,
                      pool_stride=pstride, groups=groups, route=route,
                      weight_prefetch=prefetch, row_parallel=row_par,
                      **blocks)
            ours = conv2d_hbm_bytes(B, H, H, C, K, r, m, **kw)
            ref = j_wg.conv2d_hbm_bytes(B, H, H, C, K, r, m, **kw)
            assert ours == ref, (m, kw)
            n += 1
    assert n >= 288


def _served_hbm(spec, B, h, c_in, c_out, kernel, model_routes,
                hbm_bytes=conv2d_hbm_bytes, **kw):
    route, wino = model_routes[kernel]
    return hbm_bytes(
        B, h, h, c_in, c_out, spec.kernel,
        spec.winograd_m if wino else None, stride=spec.stride,
        padding=spec.padding, relu=spec.relu, fuse_lrn=spec.fuse_lrn,
        fuse_pool=spec.fuse_pool, groups=spec.groups, route=route, **kw)


def test_model_routes_through_resolve_kernel():
    """Each AlexNet layer on each route resolves to the reference's
    datapath, and MODEL_ROUTES gives it the reference's model terms."""
    cfg, j_cfg = get_config("alexnet"), j_get_config("alexnet")
    assert set(t_conv.MODEL_ROUTES) == {KERNEL_NAMES[k]
                                         for k in j_conv.MODEL_ROUTES}
    h, c_in = cfg.image_size, cfg.in_channels
    for spec, j_spec, c_out in zip(alexnet.layer_specs(cfg),
                                   j_alexnet.layer_specs(j_cfg),
                                   cfg.conv_channels):
        for route in ("pallas", "winograd", "direct", "auto"):
            kernel = t_conv.resolve_kernel(spec.with_route(route), in_hw=h)
            j_kernel = j_conv.resolve_kernel(j_spec.with_route(route),
                                             in_hw=h)
            assert kernel == KERNEL_NAMES[j_kernel], (route, kernel)
            assert t_conv.MODEL_ROUTES[kernel] == \
                j_conv.MODEL_ROUTES[j_kernel]
            assert _served_hbm(spec, 8, h, c_in, c_out, kernel,
                               t_conv.MODEL_ROUTES) == _served_hbm(
                j_spec, 8, h, c_in, c_out, j_kernel, j_conv.MODEL_ROUTES,
                j_wg.conv2d_hbm_bytes)
        h, c_in = spec.out_hw(h), c_out


def _alexnet_rooflines(hw, dtype, module=roofline, hbm_bytes=conv2d_hbm_bytes,
                       flops=conv_flops, prefetch=True):
    cfg = get_config("alexnet")
    h, c_in, out = cfg.image_size, cfg.in_channels, []
    for i, (spec, c_out) in enumerate(zip(alexnet.layer_specs(cfg),
                                          cfg.conv_channels)):
        kernel = t_conv.resolve_kernel(spec.with_route("pallas"), in_hw=h)
        wino = t_conv.MODEL_ROUTES[kernel][1]
        hb = _served_hbm(spec, 8, h, c_in, c_out, kernel, t_conv.MODEL_ROUTES,
                         hbm_bytes, weight_prefetch=prefetch)
        o = t_conv.conv_out_hw(h, spec.kernel, spec.stride, spec.padding)
        madds = flops(o, o, c_in // spec.groups, c_out, spec.kernel,
                      spec.winograd_m if wino else None)[1 if wino else 0]
        kw = {} if hw is None else {"hw": hw, "dtype": dtype}
        out.append(module.conv_layer_roofline(
            f"conv{i + 1}", hb, flops=2 * 8 * madds, weight_prefetch=prefetch,
            **kw))
        h, c_in = spec.out_hw(h), c_out
    return out


def _close(ours: dict, ref: dict):
    for k, v in ref.items():
        if isinstance(v, (str, bool)):
            assert ours[k] == v, k
        else:
            assert math.isclose(ours[k], v, rel_tol=1e-12, abs_tol=0.0), k


@pytest.mark.parametrize("prefetch", [True, False])
def test_conv_rooflines_at_reference_constants(prefetch):
    ours = _alexnet_rooflines(REF_HW, "bfloat16", prefetch=prefetch)
    ref = _alexnet_rooflines(None, None, j_roofline, j_wg.conv2d_hbm_bytes,
                             j_wg.conv_flops, prefetch=prefetch)
    for a, b in zip(ours, ref):
        _close(a.to_json(), b.to_json())
        assert a.to_json()["peak_flops"] == REF_HW.peak_bf16
    _close(roofline.network_conv_roofline(ours, hw=REF_HW, dtype="bfloat16"),
           j_roofline.network_conv_roofline(ref))


def test_conv_rooflines_at_the_card_use_the_fp32_peak():
    layers = _alexnet_rooflines(H100_SXM, "float32")
    for lr in layers:
        assert lr.t_compute == lr.flops / 67e12
        assert lr.t_memory == lr.exposed_bytes / 3.35e12
        assert lr.bound == "compute"      # every AlexNet layer at batch 8
    net = roofline.network_conv_roofline(layers)
    assert net["peak_flops"] == 67e12 and net["hbm_bw"] == 3.35e12
    assert net["t_compute"] == sum(lr.flops for lr in layers) / 67e12


# --- the model's own checks (tests/test_fused_pipeline.py's, on the port) ---
def test_hbm_model_fused_strictly_lower_for_all_alexnet_layers():
    cfg = get_config("alexnet")
    h, c_in = cfg.image_size, cfg.in_channels
    for spec, c_out in zip(alexnet.layer_specs(cfg), cfg.conv_channels):
        kernel = t_conv.resolve_kernel(spec.with_route("pallas"))
        assert kernel.startswith("cuda"), spec
        hb = _served_hbm(spec, 1, h, c_in, c_out, kernel, t_conv.MODEL_ROUTES)
        assert hb["layer_fused_bytes"] < hb["layer_unfused_bytes"], spec
        assert hb["layer_fused_bytes"] < hb["layer_unfused_direct_bytes"]
        assert hb["fused_savings"] > 1.0
        h, c_in = spec.out_hw(h), c_out


def test_hbm_model_direct_route_gets_no_fusion_credit():
    cfg = get_config("alexnet")
    spec = alexnet.layer_specs(cfg)[0]
    hb = _served_hbm(spec, 1, cfg.image_size, cfg.in_channels,
                     cfg.conv_channels[0], "direct", t_conv.MODEL_ROUTES)
    assert hb["layer_fused_bytes"] == hb["layer_unfused_bytes"]
    assert hb["stream_bytes"] == hb["raw_bytes"]
    assert hb["fused_savings"] == 1.0


def test_hbm_model_direct_kernel_strided_slab_terms():
    hb = conv2d_hbm_bytes(1, 227, 227, 3, 96, 11, None, stride=4,
                          padding="VALID", relu=True, fuse_lrn=True,
                          fuse_pool=True, route="pallas")
    assert hb["tile_inflation"] == 0.0
    raw = 227 * 227 * 3 * 4
    assert raw <= hb["stream_bytes"] <= 1.3 * raw
    assert hb["fused_savings"] > 2.0
    assert hb["layer_fused_bytes"] < hb["layer_unfused_direct_bytes"]


def test_hbm_model_filter_cache_reuse():
    hb = conv2d_hbm_bytes(8, 13, 13, 256, 384, 3, 4, batch_block=8)
    assert hb["filter_cache_reuse"] == 8.0
    assert hb["weight_hbm_bytes"] * 8 == hb["weight_hbm_nocache_bytes"]
    hb1 = conv2d_hbm_bytes(8, 13, 13, 256, 384, 3, 4, batch_block=1)
    assert hb1["filter_cache_reuse"] == 1.0


def test_hbm_model_prefetch_exposure_terms():
    kw = dict(groups=2, fuse_lrn=True, fuse_pool=True, route="pallas",
              batch_block=4)
    hb = conv2d_hbm_bytes(8, 27, 27, 96, 256, 5, None, **kw)
    assert hb["weight_exposed_prefetch_bytes"] == 2 * hb["weight_tile_bytes"]
    assert hb["weight_exposed_noprefetch_bytes"] == hb["weight_hbm_bytes"]
    assert hb["weight_fetches"] > 1
    assert (hb["weight_exposed_prefetch_bytes"]
            < hb["weight_exposed_noprefetch_bytes"])
    assert (hb["weight_hbm_hidden_bytes"] + hb["weight_hbm_exposed_bytes"]
            == hb["weight_hbm_bytes"])
    off = conv2d_hbm_bytes(8, 27, 27, 96, 256, 5, None, weight_prefetch=False,
                           **kw)
    assert off["weight_hbm_exposed_bytes"] == off["weight_hbm_bytes"]
    assert off["weight_hbm_hidden_bytes"] == 0
    direct = conv2d_hbm_bytes(8, 27, 27, 96, 256, 5, None, groups=2,
                              route="direct")
    assert direct["weight_hbm_exposed_bytes"] == direct["weight_hbm_bytes"]
    assert direct["weight_hbm_hidden_bytes"] == 0


def test_hbm_model_prefetch_exposed_below_noprefetch_all_layers():
    cfg = get_config("alexnet")
    h, c_in = cfg.image_size, cfg.in_channels
    for spec, c_out in zip(alexnet.layer_specs(cfg), cfg.conv_channels):
        kernel = t_conv.resolve_kernel(spec.with_route("pallas"))
        hb = _served_hbm(spec, 8, h, c_in, c_out, kernel,
                         t_conv.MODEL_ROUTES, k_block=32, batch_block=4)
        assert hb["weight_fetches"] > 1, spec
        assert (hb["weight_exposed_prefetch_bytes"]
                < hb["weight_exposed_noprefetch_bytes"]), spec
        h, c_in = spec.out_hw(h), c_out


def test_hbm_model_single_tile_stream_fetched_once():
    hb = conv2d_hbm_bytes(8, 227, 227, 3, 96, 11, None, stride=4,
                          padding="VALID", relu=True, fuse_lrn=True,
                          fuse_pool=True, route="pallas", batch_block=4)
    assert hb["weight_fetches"] == 1
    assert hb["weight_hbm_bytes"] == hb["weight_tile_bytes"]
    assert (hb["weight_exposed_prefetch_bytes"]
            == hb["weight_exposed_noprefetch_bytes"]
            == hb["weight_tile_bytes"])
    assert hb["weight_hbm_hidden_bytes"] == 0


def test_conv_layer_roofline_terms():
    """Hiding the filter stream raises the effective intensity and can
    flip a layer from memory- to compute-bound."""
    hb = conv2d_hbm_bytes(8, 27, 27, 96, 256, 5, None, groups=2,
                          fuse_lrn=True, fuse_pool=True, route="pallas")
    on = roofline.conv_layer_roofline("conv2", hb, flops=1e9)
    off = roofline.conv_layer_roofline("conv2", hb, flops=1e9,
                                       weight_prefetch=False)
    assert on.ai_total == off.ai_total
    assert on.ai_exposed > off.ai_exposed
    assert on.t_memory < off.t_memory
    assert on.weight_hidden_bytes > 0 and off.weight_hidden_bytes == 0
    # at the card's FP32 peak 5e10 flop take 0.75 ms: 1e9 B (0.30 ms)
    # exposed leave it compute-bound, 5e9 B (1.49 ms) memory-bound
    big = roofline.ConvLayerRoofline("x", flops=5e10, feature_bytes=1e9,
                                     weight_bytes=4e9,
                                     weight_exposed_bytes=1e6)
    small = roofline.ConvLayerRoofline("x", flops=5e10, feature_bytes=1e9,
                                       weight_bytes=4e9,
                                       weight_exposed_bytes=4e9)
    assert big.bound == "compute" and small.bound == "memory"
    net = roofline.network_conv_roofline([on, off])
    assert net["weight_bytes"] == on.weight_bytes + off.weight_bytes
    assert net["bound"] in ("compute", "memory")


# --- conv2d_direct ------------------------------------------------------------
@pytest.mark.parametrize("r,stride,padding", [(3, 1, "SAME"), (11, 4, "VALID"),
                                              (5, 2, "SAME"), (3, 2, "VALID")])
def test_conv2d_direct_matches_the_reference(r, stride, padding):
    import jax.numpy as jnp
    rng = np.random.default_rng(r * 10 + stride)
    x = rng.standard_normal((2, 23, 19, 6)).astype(np.float32)
    w = (rng.standard_normal((r, r, 6, 5)) / r).astype(np.float32)
    ours = t_wg.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w),
                              stride=stride, padding=padding)
    ref = np.asarray(j_wg.conv2d_direct(jnp.asarray(x), jnp.asarray(w),
                                        stride=stride, padding=padding))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# --- chip_smoke.py's use of the model -----------------------------------------
@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_takes_its_peaks_from_the_roofline(chip_smoke):
    assert chip_smoke.HW is roofline.H100_SXM
    src = (ROOT / "chip_smoke.py").read_text()
    for literal in ("67e12", "989e12", "1.979e15", "3.35e12", "PEAK_"):
        assert literal not in src, literal
    assert chip_smoke._bound(67e9, 1.0) == (1.0, "operations")
    assert chip_smoke._bound(1.0, 3.35e9) == (1.0, "bytes")
    assert chip_smoke._bound(989e9, 1.0, "bfloat16")[0] == 1.0
    assert chip_smoke._bound(1.979e12, 1.0, "int8")[0] == 1.0


def _served_plans():
    """(layer, kname, plan, x on the meta device) of each AlexNet layer at
    batch 8, as phase 3 plans it."""
    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    h, c_in, out = cfg.image_size, cfg.in_channels, []
    for i, (spec, c_out) in enumerate(zip(alexnet.layer_specs(cfg),
                                          cfg.conv_channels)):
        spec = spec.with_route("pallas")
        kernel = t_conv.resolve_kernel(spec, in_hw=h)
        lrn, pool = t_conv._spec_fusion(spec)
        w_shape = (spec.kernel, spec.kernel, c_in // spec.groups, c_out)
        p = t_conv._kernel_weight_plan(spec, kernel, (8, h, h, c_in), w_shape,
                                       lrn=lrn, pool=pool,
                                       knobs=t_conv.plan_knobs())
        kname = ("conv_direct" if kernel == "cuda-direct"
                 else "conv_winograd_fused" if p.fused else "conv_winograd")
        out.append((f"conv{i + 1}", kname, p,
                    torch.empty((8, h, h, c_in), device="meta"),
                    torch.empty((8, p.ph_out, p.pw_out, c_out),
                                device="meta")))
        h, c_in = spec.out_hw(h), c_out
    return cfg, out


def test_phase3_operations_are_conv_flops(chip_smoke):
    """flops_bytes counts 2 x batch x conv_flops on the layer's datapath,
    so phase 13's t_compute is phase 3's operation bound."""
    _, plans = _served_plans()
    for layer, kname, p, x, y in plans:
        flops, nbytes = chip_smoke.flops_bytes(kname, x, y, p)
        m = None if kname == "conv_direct" else p.m
        direct, wino = conv_flops(p.out_h, p.out_w, p.C, p.Kfull, p.r, m)
        assert flops == 2 * 8 * (direct if m is None else wino), layer
        assert nbytes > x.numel() * 4


def _fake_run(chip_smoke, cfg, plans, scale):
    """Phase 13's inputs with each measured time ``scale`` x the
    model's floor (layer kernel_ms; the rest generous)."""
    rows = {}
    for layer, kname, p, x, y in plans:
        flops, nbytes = chip_smoke.flops_bytes(kname, x, y, p)
        bound, by = chip_smoke._bound(flops, nbytes)
        rows.setdefault(kname, {"per_layer": []})["per_layer"].append(
            {"layer": layer, "ms": scale * bound, "bound_ms": bound,
             "bound_by": by})
    serve = {"batch_device_busy_ms": 1.0, "batch_conv_direct_ms": 0.3,
             "batch_conv_winograd_ms": 0.1, "batch_wall_ms": 20.0,
             "imgs_per_s": 1500.0}
    lm = {"max_len": 512, "step_ms": 60.0, "device_busy_ms_per_step": 6.0}
    granite = {"max_len": 512, "step_ms": 70.0,
               "device_busy_ms_per_step": 8.0}
    train = {"step_ms": 500.0, "device_busy_ms": 100.0}
    return rows, serve, lm, granite, train


def test_phase_model_on_the_cpu(chip_smoke):
    cfg, plans = _served_plans()
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = chip_smoke.phase_model(cfg, "card", *_fake_run(
            chip_smoke, cfg, plans, 4.0))
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("model:")]
    assert len(lines) == 10 and all(ln.endswith("| on card")
                                    for ln in lines[:-1])
    assert [lr["kernel_over_model"] for lr in out["alexnet"]["layers"]] == \
        pytest.approx([4.0] * 5, rel=1e-12)
    assert 0 < out["alexnet"]["share_of_fp32_peak"] <= 1
    g = out["decode"]["granite-moe-1b-a400m"]
    assert g["n_total"] > g["n_active"] and g["bound"] == "memory"
    assert 0 < out["train"]["share_of_bf16_peak_device"] <= 1
    # a kernel faster than its floor fails the run
    with redirect_stdout(io.StringIO()), pytest.raises(
            chip_smoke.CheckFailed, match="under the model"):
        chip_smoke.phase_model(cfg, "card", *_fake_run(chip_smoke, cfg,
                                                       plans, 0.5))
