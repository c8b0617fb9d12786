"""Block floating point in a bf16 image model (``dtype="bfloat16"`` with
``fc_bfp`` and/or ``conv_bfp``) in the PyTorch port against the JAX
package, on the CPU.

The reference quantizes a bf16 model's conv slabs and dequantizes them to
f32 (its ``core/bfp.py::dequantize`` returns f32 whatever it was given),
so every BFP slab is f32, the direct kernel's included: kernel 1 then
reads bf16 x with an f32 slab.  Its FC layers run ``bfp_linear`` on the
activations and weights taken as f32, add the f32 bias and round once to
bf16.  The port does the same; on a CPU tensor each kernel wrapper runs
its plain version, which holds the kernels' bf16 rule (the f32 function
of the widened inputs, rounded once).

Tolerances: reduced models within 5e-2 * max|logit| of the reference's
(PERF.md's gate for BFP and for bf16); slabs, checksum rows and fc6's
staged stream bit for bit, with the reference's ``jnp.exp2`` made exact
(``tests/test_torch_bfp.py``: XLA's CPU exp2 misses powers of two beyond
+-12).  At reduced VGG-16's fc8 (K = 24, exponent block 8) the
reference's Pallas BFP kernel does not compile in interpret mode on
XLA's CPU (ROADMAP Queue 3), so there the reference runs its plain BFP
matmul, as ``tests/test_torch_vgg.py`` does.  Inputs are made with numpy
from a seed.
"""
import dataclasses
import functools
import multiprocessing as mp
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.bfp_matmul import ops as j_bops  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.bfp_matmul import bfp_matmul as t_bk  # noqa: E402
from repro_torch.kernels.bfp_matmul import ops as t_bops  # noqa: E402
from repro_torch.kernels.conv import direct, dma, winograd  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.nn.pooling import LrnParams  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest, ModelRegistry, WorkerModel,
                                 WorkerSpec, worker_main)

TOL_MODEL = 5e-2
FLAGS = {"fc": dict(fc_bfp=True), "conv": dict(conv_bfp=True),
         "both": dict(fc_bfp=True, conv_bfp=True)}


def _exact_exp2(v):
    v = jnp.asarray(v)
    return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                     jnp.round(v).astype(jnp.int32))


@pytest.fixture(scope="module")
def exact_exp2():
    """The reference's ``jnp.exp2`` exact for integer arguments for the
    whole module (its BFP scales are powers of two by definition), and
    its BFP matmul through its plain reference where its Pallas kernel
    does not compile (reduced VGG-16's fc8); jit caches cleared around."""
    mp_ = pytest.MonkeyPatch()
    jax.clear_caches()
    mp_.setattr(jnp, "exp2", _exact_exp2)
    yield mp_
    mp_.undo()
    jax.clear_caches()


def _j_bf16(np_params):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), np_params)


@pytest.fixture(scope="module")
def alex(exact_exp2):
    """Reduced bf16 AlexNet on route pallas in both packages: the
    reference's params as f32 numpy, images, and the reference's logits
    under each BFP flag set (its kernels in interpret mode)."""
    j_cfg = dataclasses.replace(j_get_config("alexnet").reduced(),
                                dtype="bfloat16", use_pallas=True)
    t_cfg = dataclasses.replace(get_config("alexnet").reduced(),
                                dtype="bfloat16", use_pallas=True)
    np_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    imgs = np.random.default_rng(5).standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, 3)).astype(np.float32)
    jp = _j_bf16(np_params)
    refs = {k: np.asarray(j_alexnet.apply(
        jp, dataclasses.replace(j_cfg, **f), jnp.asarray(imgs)),
        np.float32) for k, f in FLAGS.items()}
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    return j_cfg, t_cfg, np_params, params, imgs, refs


def _close_model(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= TOL_MODEL * scale


@pytest.mark.parametrize("flags", list(FLAGS))
def test_reduced_alexnet_matches_jax(alex, flags):
    """bf16 AlexNet under fc_bfp, conv_bfp and both: bf16 logits within
    5e-2 of max|logit| of the reference's, and the quantization ran (the
    logits differ from the unquantized bf16 model's)."""
    _, t_cfg, _, params, imgs, refs = alex
    cfg = dataclasses.replace(t_cfg, **FLAGS[flags])
    got = alexnet.apply(params, cfg, torch.from_numpy(imgs))
    assert got.dtype is torch.bfloat16
    _close_model(got, refs[flags])
    plain = alexnet.apply(params, t_cfg, torch.from_numpy(imgs))
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("abft", [False, True], ids=["unarmed", "armed"])
def test_slabs_equal_the_references(alex, abft):
    """pack_serving_slabs of the bf16 BFP model: every conv slab f32 (the
    direct ones too), with the reference's shape, dtype and bytes, so
    each fingerprint's shape, dtype and crc32 are the reference's and its
    context differs only by the datapath's name; armed, the checksum rows
    are the reference's bit for bit and verdict-clean.  fc6-fc8's streams
    are the reference's mantissas and exponents."""
    j_cfg, t_cfg, np_params, params, _, _ = alex
    change = dict(FLAGS["both"], sdc_abft=abft)
    j_packed = j_alexnet.pack_serving_slabs(
        _j_bf16(np_params), dataclasses.replace(j_cfg, **change), 2,
        fingerprint=True)
    packed = alexnet.pack_serving_slabs(
        params, dataclasses.replace(t_cfg, **change), 2, fingerprint=True)
    for i in range(1, 6):
        name = f"conv{i}"
        got, ref = packed[name], j_packed[name]
        want = np.asarray(ref.data)
        assert got.data.dtype is torch.float32 and want.dtype == np.float32
        assert tuple(got.data.shape) == want.shape, name
        assert np.array_equal(got.data.numpy().view(np.uint8),
                              want.view(np.uint8)), name
        fp, jfp = got.fingerprint, ref.fingerprint
        assert (fp.shape, fp.dtype, fp.crc32) == (
            tuple(jfp.shape), jfp.dtype, jfp.crc32), name
        assert fp.context == jfp.context.replace("pallas-", "cuda-")
        assert t_conv.verify_packed(got)
        if abft:
            assert int(dma.checksum_mismatches(got.data)) == 0
            rows = torch.from_numpy(np.ascontiguousarray(want[..., :-1, :]))
            # compared as bytes: a checksum row's words may be NaN patterns
            assert np.array_equal(
                dma.append_checksum_row(rows).numpy().view(np.uint8),
                want.view(np.uint8)), name
    # the reference stages fc6 only (fc7 and fc8 quantize in its trace)
    wq, we = packed["fc6"]
    jq, je = j_packed["fc6"]
    assert np.array_equal(t_bk.reference_layout(wq, 32).numpy(),
                          np.asarray(jq))
    assert np.array_equal(we.numpy(), np.asarray(je))


def test_fc_streams_quantize_the_widened_bf16_weights(alex):
    """Every FC layer's staged stream is ``quantize_weights`` of the bf16
    weight widened to f32, equal to the reference's quantization of the
    same weight."""
    _, t_cfg, np_params, params, _, _ = alex
    packed = alexnet.pack_serving_slabs(
        params, dataclasses.replace(t_cfg, fc_bfp=True), 2)
    for name in ("fc6", "fc7", "fc8"):
        w = params[name]["w"]
        assert w.dtype is torch.bfloat16
        block = t_bops.fc_block(w.shape[0])
        jq, je = j_bops.quantize_weights(
            jnp.asarray(np_params[name]["w"]).astype(jnp.bfloat16)
            .astype(jnp.float32), block=block)
        wq, we = packed[name]
        assert np.array_equal(t_bk.reference_layout(wq, block).numpy(),
                              np.asarray(jq)), name
        assert np.array_equal(we.numpy(), np.asarray(je)), name


def test_classifier_casts_as_the_reference(alex):
    """fc_bfp in bf16: (bfp_linear(x, w) + b.float()).to(bf16) layer by
    layer, bfp_linear taking bf16 x as x.float(), bit for bit."""
    _, t_cfg, _, params, _, _ = alex
    cfg = dataclasses.replace(t_cfg, fc_bfp=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, alexnet.fc_input_dim(cfg))).astype(np.float32)).to(torch.bfloat16)
    got = alexnet.classifier(params, cfg, x)
    want = x
    for j, name in enumerate(("fc6", "fc7", "fc8")):
        p = params[name]
        y = t_bops.bfp_linear(want.float(), p["w"].float())
        assert torch.equal(y, t_bops.bfp_linear(want, p["w"]))
        want = (y + p["b"].float()).to(torch.bfloat16)
        if j < 2:
            want = torch.relu(want)
    assert got.dtype is torch.bfloat16 and torch.equal(got, want)


def test_kernel4_plain_reads_bf16_as_its_widening():
    """Kernel 4's wrapper takes bf16 x: its plain version (the kernel's
    bits) on bf16 x equals it on x.float(), and its pre-pass twin gives
    the same words and exponents."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    wq, we = t_bk.quantize_weights(w, block=32)
    assert torch.equal(t_bk.bfp_matmul(x, wq, we, block=32),
                       t_bk.bfp_matmul(x.float(), wq, we, block=32))
    for a, b in zip(t_bk.quantize_activations(x, 32),
                    t_bk.quantize_activations(x.float(), 32)):
        assert torch.equal(a, b)
    assert t_bk.X_DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    with pytest.raises(ValueError, match="x must be one of"):
        t_bk._check_cuda_args(x.half(), wq, we, 32)


@pytest.mark.parametrize("armed", [False, True], ids=["unarmed", "armed"])
def test_kernel1_plain_bf16_x_on_an_f32_slab(armed):
    """Kernel 1 with bf16 x and bias on an f32 (BFP) slab: its plain
    version is the f32 kernel's function on the widened x and bias,
    rounded once to bf16; armed, the same bits and a clean verdict.  The
    CUDA wrapper's input check takes that pair."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 35, 35, 3)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((11, 11, 3, 16)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    spec = t_conv.ConvSpec(kernel=11, stride=4, padding="VALID", relu=True,
                           fuse_lrn=True, fuse_pool=True, route="pallas")
    slab = t_conv.pack_conv_weights(spec, tuple(x.shape), w.to(
        torch.bfloat16), bfp_pack=True, abft=armed)
    assert slab.kernel == "cuda-direct" and slab.data.dtype is torch.float32
    kw = dict(stride=4, padding="VALID", relu=True, lrn=LrnParams(),
              pool=(3, 2), checksum=armed)
    got = direct.conv2d_direct(x, w, b, slab.data, **kw)
    ref = direct.conv2d_direct(x.float(), w, b.float(), slab.data, **kw)
    if armed:
        (got, v), (ref, v32) = got, ref
        assert int(v) == int(v32) == 0
    assert got.dtype is torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))
    direct.check_cuda_inputs("conv_direct", x, slab.data, b, 16,
                             slab_dtype=(x.dtype, torch.float32))
    with pytest.raises(ValueError, match="slab"):
        direct.check_cuda_inputs("conv_direct", x.float(),
                                 slab.data.to(torch.bfloat16), b.float(), 16,
                                 slab_dtype=(torch.float32, torch.float32))


def test_winograd_plain_bf16_x_on_a_bfp_slab():
    """Kernels 2-3 on a bf16 model's BFP slab (f32): bf16 x gives the f32
    function of the widened x, rounded once, unfused and with conv5's
    pool."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 13, 13, 16)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 8)) * 0.2).astype(
        np.float32)).to(torch.bfloat16)
    b = torch.zeros(8, dtype=torch.bfloat16)
    for pool in (None, (3, 2)):
        spec = t_conv.ConvSpec(kernel=3, groups=2, relu=True,
                               fuse_pool=pool is not None, route="pallas")
        slab = t_conv.pack_conv_weights(spec, tuple(x.shape), w,
                                        bfp_pack=True)
        assert slab.kernel == "cuda-winograd"
        kw = dict(groups=2, relu=True, pool=pool)
        got = winograd.conv2d_winograd(x, w, b, slab.data, **kw)
        ref = winograd.conv2d_winograd(x.float(), w.float(), b.float(),
                                       slab.data, **kw)
        assert torch.equal(got, ref.to(torch.bfloat16))


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [ImageRequest(image=rng.standard_normal(
        (cfg.image_size, cfg.image_size, 3)).astype(np.float32))
        for _ in range(n)]


def _bit_equal_to_apply(params, cfg, reqs):
    by_uid = {r.uid: r for r in reqs}
    for grp in {r.served_group for r in reqs}:
        x = np.zeros((by_uid[grp[0]].served_bucket, cfg.image_size,
                      cfg.image_size, 3), np.float32)
        for row, uid in enumerate(grp):
            x[row] = by_uid[uid].image
        want = alexnet.apply(params, cfg, torch.from_numpy(x)).float()
        for row, uid in enumerate(grp):
            assert np.array_equal(by_uid[uid].logits, want[row].numpy())


@pytest.mark.parametrize("abft", [False, True], ids=["unarmed", "armed"])
def test_engine_serves_bf16_bfp_bit_equal_to_apply(alex, abft):
    """CnnEngine(max_batch=4) with a bf16 BFP model (armed: the SDC plane
    on): groups of 1-3 requests, each logit bit-equal to ``apply`` on its
    served padded bucket, the accounting balanced, no detection."""
    _, t_cfg, _, params, _, _ = alex
    cfg = dataclasses.replace(t_cfg, **FLAGS["both"], sdc_abft=abft)
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=4), params=params,
                    device="cpu")
    reqs = _requests(cfg, 6, seed=3)
    i = 0
    for size in (3, 1, 2):
        for r in reqs[i:i + size]:
            eng.submit(r)
        i += size
        eng.step()
    eng.run_until_done()
    assert all(r.done and np.isfinite(r.logits).all() for r in reqs)
    plain_cfg = dataclasses.replace(cfg, sdc_abft=False)
    _bit_equal_to_apply(params, plain_cfg, reqs)
    stats = eng.stats()
    assert stats["accounting"]["balanced"]
    if abft:
        assert stats["sdc"]["detections"] == 0


@pytest.fixture(scope="module")
def vgg(exact_exp2):
    j_cfg = dataclasses.replace(j_get_config("vgg16").reduced(),
                                dtype="bfloat16", use_pallas=True,
                                **FLAGS["both"])
    t_cfg = dataclasses.replace(get_config("vgg16").reduced(),
                                dtype="bfloat16", use_pallas=True,
                                **FLAGS["both"])
    np_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        j_alexnet.init(jax.random.PRNGKey(1), j_cfg))
    imgs = np.random.default_rng(7).standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, 3)).astype(np.float32)
    exact_exp2.setattr(j_bops, "bfp_matmul",
                       functools.partial(j_bops.bfp_matmul, pallas=False))
    ref = np.asarray(j_alexnet.apply(_j_bf16(np_params), j_cfg,
                                     jnp.asarray(imgs)), np.float32)
    exact_exp2.setattr(j_bops, "bfp_matmul", j_bops.bfp_matmul.func)
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    return t_cfg, params, imgs, ref


def test_reduced_vgg_matches_jax(vgg):
    """Reduced bf16 VGG-16 under fc_bfp + conv_bfp: within 5e-2 of
    max|logit| of the reference's (its BFP matmul through its plain
    reference at fc8, ROADMAP Queue 3), and served bit-equal to apply."""
    t_cfg, params, imgs, ref = vgg
    got = alexnet.apply(params, t_cfg, torch.from_numpy(imgs))
    _close_model(got, ref)
    eng = CnnEngine(t_cfg, CnnServeConfig(max_batch=2), params=params,
                    device="cpu")
    reqs = _requests(t_cfg, 3, seed=8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    _bit_equal_to_apply(params, t_cfg, reqs)


def test_registry_serves_bf16_bfp_models(alex, vgg):
    """ModelRegistry with the bf16 BFP AlexNet and VGG-16: every request
    delivered, bit-equal to its model's apply."""
    _, a_cfg, _, a_params, _, _ = alex
    v_cfg, v_params, _, _ = vgg
    a_cfg = dataclasses.replace(a_cfg, **FLAGS["both"])
    reg = ModelRegistry(slot_budget=8)
    reg.register("alexnet", a_cfg, CnnServeConfig(max_batch=2),
                 params=a_params, device="cpu")
    reg.register("vgg16", v_cfg, CnnServeConfig(max_batch=2),
                 params=v_params, device="cpu")
    reqs = {"alexnet": _requests(a_cfg, 3, 9), "vgg16": _requests(v_cfg, 2,
                                                                  10)}
    for name, rs in reqs.items():
        for r in rs:
            assert reg.submit(name, r)
    reg.run_until_done()
    for (name, rs), (cfg, params) in zip(
            reqs.items(), ((a_cfg, a_params), (v_cfg, v_params))):
        assert all(r.done for r in rs)
        _bit_equal_to_apply(params, cfg, rs)
    assert reg.stats()["fleet"]["accounting_balanced"]


def test_worker_serves_a_bf16_bfp_model(alex, monkeypatch):
    """``worker_main`` (in a thread, over a pipe) builds and serves the
    bf16 BFP AlexNet: each result done, its logits finite and those of
    ``apply`` on the worker's seeded params."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, t_cfg, _, _, _, _ = alex
    cfg = dataclasses.replace(t_cfg, **FLAGS["both"])
    conn, child = mp.Pipe()
    t = threading.Thread(target=worker_main, args=(child, WorkerSpec(
        "w0", (WorkerModel("alexnet", cfg, CnnServeConfig(max_batch=2),
                           seed=0),), device="cpu")), daemon=True)
    t.start()
    ready = conn.recv()
    assert ready["ok"], ready
    rng = np.random.default_rng(11)
    imgs = rng.standard_normal((3, cfg.image_size, cfg.image_size,
                                3)).astype(np.float32)
    seq = 0

    def call(**msg):
        nonlocal seq
        seq += 1
        conn.send(dict(msg, seq=seq))
        assert conn.poll(120), msg
        reply = conn.recv()
        assert reply["seq"] == seq
        return reply

    for i, im in enumerate(imgs):
        assert call(op="submit", model="alexnet", uid=100 + i,
                    image=im)["accepted"]
    for _ in range(50):
        if call(op="step", n=1)["drained"]:
            break
    out = {r["uid"]: r for r in call(op="retire_batch")["results"]}
    assert sorted(out) == [100, 101, 102]
    params = alexnet.init(0, cfg, device="cpu")
    for rec in out.values():
        assert rec["status"] == "done" and np.isfinite(rec["logits"]).all()
        x = np.zeros((rec["bucket"], cfg.image_size, cfg.image_size, 3),
                     np.float32)
        for row, uid in enumerate(rec["group"]):
            x[row] = imgs[uid - 100]
        want = alexnet.apply(params, cfg, torch.from_numpy(x)).float()
        assert np.array_equal(rec["logits"],
                              want[rec["group"].index(rec["uid"])].numpy())
    assert call(op="shutdown")["bye"]
    t.join(timeout=10)
