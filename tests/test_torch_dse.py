"""The analytic models of the PyTorch port (``repro_torch.core.dse``,
``core/roofline.py``'s work counts, ``config.py``'s shape cells) against
the JAX package's, on the CPU.

Part 1 of the DSE is the paper's FPGA model: the port's must give the
reference's numbers exactly, and the paper's own checks
(``tests/test_dse.py``) hold on it.  Part 2 takes its rates from a
``Hardware`` record: built from the reference's constants (read from
``repro.core.roofline`` here, never typed), it must give the reference's
numbers within 1e-12 relative; at ``H100_SXM`` the decode batching curve
must saturate.  The work counts are integers in floats, equal exactly.
"""
import dataclasses
import math

import pytest

from repro import config as j_config
from repro.configs import get_config as j_get_config
from repro.core import dse as j_dse
from repro.core import roofline as j_roofline
from repro_torch import config as t_config
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.core import dse, roofline
from repro_torch.core.roofline import H100_SXM

# the reference's constants in a Hardware record: its one bf16 peak, HBM
# and link rates (the other fields are not read by part 2)
REF_HW = dataclasses.replace(
    H100_SXM, name="reference", peak_bf16=j_roofline.PEAK_FLOPS_BF16,
    hbm_bw=j_roofline.HBM_BW, link_bw=j_roofline.ICI_BW)

C_VECS = (2, 4, 8, 16)
K_VECS = tuple(range(8, 129, 8))


def _isclose(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def _rows_close(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert _isclose(a[k], b[k]), (k, a[k], b[k])


# --- part 1: the paper's FPGA model -----------------------------------------
def test_tables_equal_the_reference():
    for name in ("ALEXNET_CONV", "ALEXNET_FC", "ALEXNET_FEATURES",
                 "A10_1150_DSPS", "A10_1150_M20K", "S_VEC"):
        assert getattr(dse, name) == getattr(j_dse, name), name
    assert dataclasses.asdict(dse.DLAConfig()) == dataclasses.asdict(
        j_dse.DLAConfig())


@pytest.mark.parametrize("winograd", [True, False])
@pytest.mark.parametrize("c_vec", C_VECS)
def test_resource_and_throughput_equal_the_reference(c_vec, winograd):
    """n_dsps, n_m20k_*, fits_device, every layer's cycles and
    alexnet_throughput, exactly, over the Fig. 8 sweep's K_vec."""
    for k_vec in K_VECS:
        ours = dse.DLAConfig(c_vec=c_vec, k_vec=k_vec, winograd=winograd)
        ref = j_dse.DLAConfig(c_vec=c_vec, k_vec=k_vec, winograd=winograd)
        assert dse.n_dsps(ours) == j_dse.n_dsps(ref)
        assert dse.n_m20k_stream(ours) == j_dse.n_m20k_stream(ref)
        assert dse.n_m20k_filter(ours) == j_dse.n_m20k_filter(ref)
        assert dse.fits_device(ours) == j_dse.fits_device(ref)
        for i, layer in enumerate(dse.ALEXNET_CONV):
            nxt = dse.ALEXNET_CONV[i + 1] if i + 1 < 5 else None
            assert dse.dsp_efficiency(layer, ours) == j_dse.dsp_efficiency(
                layer, ref)
            assert dse.conv_cycles(layer, nxt, ours) == j_dse.conv_cycles(
                layer, nxt, ref)
        for layer in dse.ALEXNET_FC:
            assert dse.fc_cycles(layer, ours) == j_dse.fc_cycles(layer, ref)
        for overhead in (0.0, 0.16):
            assert dse.alexnet_throughput(
                ours, system_overhead=overhead) == j_dse.alexnet_throughput(
                ref, system_overhead=overhead)


def test_explore_fpga_equals_the_reference():
    assert dse.explore_fpga() == j_dse.explore_fpga()
    assert dse.explore_fpga((4, 8), (16, 48, 96)) == j_dse.explore_fpga(
        (4, 8), (16, 48, 96))
    for r, m in ((3, 2), (3, 4), (3, 6), (4, 3)):
        assert dse.winograd_speedup(r, m) == j_dse.winograd_speedup(r, m)


def test_resource_model_paper_config():
    """8x48 fits the A10-1150 (the paper's final config); the next K_vec
    step does not."""
    cfg = dse.DLAConfig(c_vec=8, k_vec=48)
    assert dse.fits_device(cfg)
    assert dse.n_dsps(cfg) == 1352                # 2304/2 + 200
    assert not dse.fits_device(dse.DLAConfig(c_vec=8, k_vec=56))


def test_table2_per_layer_efficiency():
    """Table 2's DSP efficiencies: conv5 within 0.005, conv3/4 within 3%,
    FC ~100%, conv1/conv2 within 15%."""
    r = dse.alexnet_throughput(dse.DLAConfig(c_vec=8, k_vec=48))
    eff = {l["name"]: l["dsp_eff"] for l in r["layers"]}
    paper = {"conv1": .829, "conv2": .625, "conv3": .724, "conv4": .724,
             "conv5": .626}
    assert abs(eff["conv5"] - paper["conv5"]) < 0.005
    for name in ("conv3", "conv4"):
        assert abs(eff[name] - paper[name]) < 0.03
    for name in ("fc6", "fc7", "fc8"):
        assert eff[name] > 0.97
    for name in ("conv1", "conv2"):
        assert abs(eff[name] - paper[name]) < 0.15


def test_headline_throughput():
    """1,020 img/s measured; the model with the paper's 16% system
    overhead within 15%."""
    r = dse.alexnet_throughput(dse.DLAConfig(c_vec=8, k_vec=48),
                               system_overhead=0.16)
    assert abs(r["img_per_s"] - 1020) / 1020 < 0.15, r["img_per_s"]


def test_fig8_sweep_optimum():
    """8x48 within 2% of the sweep's best; infeasible points zeroed."""
    rows = dse.explore_fpga()
    best = max(r["img_per_s"] for r in rows)
    p848 = next(r for r in rows if r["c_vec"] == 8 and r["k_vec"] == 48)
    assert p848["img_per_s"] > 0.98 * best
    assert any(r["img_per_s"] == 0 for r in rows)


def test_fc_batching_curve():
    """Eq. 6's crossover: DDR-bound at batch 4, compute-bound at 96."""
    lo = dse.fc_cycles(("fc6", 9216, 4096), dse.DLAConfig(s_batch=4))
    hi = dse.fc_cycles(("fc6", 9216, 4096), dse.DLAConfig(s_batch=96))
    assert lo["cycles"] / lo["ideal_cycles"] > 2.0
    assert hi["cycles"] / hi["ideal_cycles"] < 1.05


# --- part 2: the card's cost model -------------------------------------------
def _inputs(kind):
    kw = dict(n_active=3e9, n_total=3.6e9, seq_len=32768, global_batch=16,
              kind=kind, d_model=3072, num_layers=28,
              cache_bytes_per_token=1e4)
    return dse.ModelInput(**kw), j_dse.TPUModelInput(**kw)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lm_cost_at_reference_constants(kind):
    ours, ref = _inputs(kind)
    for data, model, pod in ((1, 1, 1), (16, 16, 1), (8, 4, 2), (256, 1, 1)):
        for dtype_bytes, gc in ((2, 1.0), (4, 0.5)):
            a = dse.lm_cost(ours, data=data, model=model, pod=pod,
                            dtype_bytes=dtype_bytes, grad_compress=gc,
                            hw=REF_HW)
            b = j_dse.lm_cost(ref, data=data, model=model, pod=pod,
                              dtype_bytes=dtype_bytes, grad_compress=gc)
            _rows_close([a], [b])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_explore_and_batch_curve_at_reference_constants(kind):
    ours, ref = _inputs(kind)
    for chips, pods in ((256, 1), (64, 2)):
        _rows_close(dse.explore_gpu(ours, chips, pods, hw=REF_HW),
                    j_dse.explore_tpu(ref, chips, pods))
    _rows_close(dse.decode_batch_curve(ours, data=16, model=16, hw=REF_HW),
                j_dse.decode_batch_curve(ref, data=16, model=16))


def test_h100_decode_batch_curve_saturates():
    """The FC crossover on the card: tokens/s grows with the batch while
    the weight stream dominates, with diminishing returns."""
    inp = dse.ModelInput(n_active=3e9, n_total=3e9, seq_len=32768,
                         global_batch=1, kind="decode", d_model=3072,
                         num_layers=28, cache_bytes_per_token=1e4)
    rows = dse.decode_batch_curve(inp, data=16, model=16)
    tps = [r["throughput_tokens_s"] for r in rows]
    assert tps[-1] > tps[0] * 4
    assert tps[1] / tps[0] > tps[-1] / tps[-2]
    assert rows[0]["bound"] == "memory"
    # at one card the model is H100's: 6 GB of bf16 weights at 3.35 TB/s
    one = dse.lm_cost(inp, data=1, model=1)
    assert one["t_memory"] == pytest.approx(
        (3e9 * 2 + 1e4 * 32768) / H100_SXM.hbm_bw, rel=1e-12)


def test_peaks_in_one_place():
    assert roofline.PEAK_FLOPS_BF16 == H100_SXM.peak_bf16 == 989e12
    assert roofline.HBM_BW == H100_SXM.hbm_bw == 3.35e12
    assert roofline.LINK_BW == H100_SXM.link_bw
    assert [H100_SXM.peak(d) for d in ("float32", "tf32", "bfloat16",
                                       "int8")] == [67e12, 495e12, 989e12,
                                                    1.979e15]
    with pytest.raises(KeyError):
        H100_SXM.peak("float64")


def test_roofline_terms_at_reference_constants():
    kw = dict(arch="smollm-360m", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=3.1e15, hbm_bytes_per_device=2.2e12,
              coll_bytes_per_device=4.5e11, coll_breakdown={"count": 3},
              peak_memory_bytes=7e9, model_flops=5e17)
    ours = roofline.RooflineTerms(**kw, hw=REF_HW).to_json()
    ref = j_roofline.RooflineTerms(**kw).to_json()
    for k, v in ref.items():
        assert _isclose(ours[k], v) if not isinstance(v, dict) else \
            ours[k] == v, k
    assert ours["peak_flops"] == REF_HW.peak_bf16
    assert ours["link_bw"] == REF_HW.link_bw


# --- config: shape cells and work counts -------------------------------------
def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_config.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_config.SHAPES.items()}
    for arch in LM_ARCHS:
        cfg, ref = get_config(arch), j_get_config(arch)
        assert cfg.attn_supported_long == ref.attn_supported_long, arch
        assert cfg.has_decoder == ref.has_decoder
        for name, shape in t_config.SHAPES.items():
            ok, why = t_config.shape_applicable(cfg, shape)
            j_ok, _ = j_config.shape_applicable(ref, j_config.SHAPES[name])
            assert ok == j_ok and bool(why) == (not ok), (arch, name)


def test_registries_hold_the_same_lms():
    from repro.configs import list_configs
    assert set(LM_ARCHS) == set(list_configs()) - {"alexnet", "vgg16"}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_work_counts_equal_the_reference(arch, reduced):
    """active_param_count and model_flops_estimate under every shape, on
    each package's own config of ``arch``."""
    cfg, ref = get_config(arch), j_get_config(arch)
    if reduced:
        cfg, ref = cfg.reduced(), ref.reduced()
    assert roofline.active_param_count(cfg) == \
        j_roofline.active_param_count(ref)
    for name, shape in t_config.SHAPES.items():
        assert roofline.model_flops_estimate(cfg, shape) == \
            j_roofline.model_flops_estimate(ref, j_config.SHAPES[name])
    total = roofline.total_param_count(cfg)
    if cfg.moe is None:
        assert total == roofline.active_param_count(cfg)
    else:
        assert total > roofline.active_param_count(cfg)
        mo = cfg.moe
        moe_layers = sum(cfg.layer_kind(i)[1] == "moe"
                         for i in range(cfg.num_layers))
        assert total - roofline.active_param_count(cfg) == (
            moe_layers * 3 * cfg.d_model * mo.d_ff
            * (mo.num_experts - mo.top_k))
