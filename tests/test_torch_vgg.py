"""VGG-16 in the PyTorch port against the JAX package, on the CPU.

The config and its layer table must be field-equal to the reference's, the
shape chain must end at 7 * 7 * 512 = 25088 features at full width, and
at reduced size the port's forward on every route must agree with the
reference's on the reference's own parameters (carried over as numpy):
logits within rtol 1e-4, atol 1e-4 * max|logit| (both float32, summed in
other orders; ``tests/test_torch_alexnet.py``'s bound).  The Winograd
kernels' plain versions are held to the reference's Pallas kernels (in
interpret mode, as ``tests/test_vgg_geometry.py`` runs them) at that
file's VGG-proportioned geometries: several channel blocks, 2x2/2 pools,
partial pooled-row blocks, within rtol 1e-5, atol 1e-5 * max|ref| (f32
transforms and 128-channel sums in other orders).  Every input is made
with numpy from a seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.bfp_matmul import ops as j_bops  # noqa: E402
from repro.kernels.conv import winograd as j_wk  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro_torch.configs import CNN_ARCHS, get_config  # noqa: E402
from repro_torch.kernels.conv import winograd as t_wk  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest)

ROUTES = {"direct": dict(use_winograd=False),
          "winograd": dict(),
          "pallas": dict(use_pallas=True)}


@pytest.fixture(scope="module")
def reduced():
    """Reduced VGG-16 in both packages, the JAX params as numpy, images."""
    j_cfg = j_get_config("vgg16").reduced()
    np_params = jax.tree_util.tree_map(
        np.asarray, j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    imgs = np.random.default_rng(0).standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, j_cfg.in_channels)
    ).astype(np.float32)
    return j_cfg, get_config("vgg16").reduced(), np_params, imgs


def _close(got, ref, err_msg=""):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max(), err_msg=err_msg)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_config_and_layer_specs_equal_the_references(full):
    j_cfg, t_cfg = j_get_config("vgg16"), get_config("vgg16")
    if not full:
        j_cfg, t_cfg = j_cfg.reduced(), t_cfg.reduced()
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    j_specs, t_specs = j_alexnet.layer_specs(j_cfg), alexnet.layer_specs(t_cfg)
    assert len(t_specs) == len(j_specs) == len(t_cfg.conv_channels)
    for j_s, t_s in zip(j_specs, t_specs):
        assert dataclasses.asdict(t_s) == dataclasses.asdict(j_s)


def test_registry_names_both_cnns():
    assert CNN_ARCHS == ["alexnet", "vgg16"]
    assert get_config("vgg16").arch == "vgg"


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_shape_chain(full):
    """13 convs, all Winograd on route pallas, five of them pooled; the
    features end at 7 x 7 x 512 = 25088 at full width."""
    j_cfg, t_cfg = j_get_config("vgg16"), get_config("vgg16")
    if not full:
        j_cfg, t_cfg = j_cfg.reduced(), t_cfg.reduced()
    assert alexnet.fc_input_dim(t_cfg) == j_alexnet._fc_input_dim(j_cfg)
    if full:
        assert alexnet._feature_hw(t_cfg) == 7
        assert alexnet.fc_input_dim(t_cfg) == 25088
    cfg = dataclasses.replace(t_cfg, use_pallas=True)
    routes = alexnet.layer_routes(cfg)
    assert [k for _, k in routes] == ["cuda-winograd"] * len(
        t_cfg.conv_channels)
    j_routes = j_alexnet.layer_routes(dataclasses.replace(j_cfg,
                                                          use_pallas=True))
    assert [(n, k.replace("pallas-", "cuda-")) for n, k in j_routes] == routes
    pooled = [s.fuse_pool for s in alexnet.layer_specs(t_cfg)]
    assert sum(pooled) == len(t_cfg.pool_after)
    params = alexnet.init(0, t_cfg.reduced() if full else t_cfg,
                          device="cpu")
    assert tuple(params["fc6"]["w"].shape)[0] == alexnet.fc_input_dim(
        t_cfg.reduced() if full else t_cfg)


# the Winograd kernels at tests/test_vgg_geometry.py's VGG-proportioned
# geometries: (H, C, K, B, seed, pool, pool_row_block)
GEOMETRIES = {
    "multi_cblock": (72, 128, 8, 8, 0, None, None),
    "multi_cblock_pool2": (72, 96, 8, 8, 1, (2, 2), None),
    "pool2_rows1": (28, 24, 12, 3, 3, (2, 2), 1),
    "pool2_rows3": (28, 24, 12, 3, 3, (2, 2), 3),
    "pool2_rows_auto": (28, 24, 12, 3, 3, (2, 2), None),
}


def _vgg_case(H, C, K, B, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, H, C)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, K)) * 0.1).astype(np.float32)
    b = rng.standard_normal((K,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_winograd_plain_matches_jax_kernel_on_vgg_geometry(name):
    H, C, K, B, seed, pool, prb = GEOMETRIES[name]
    x, w, b = _vgg_case(H, C, K, B, seed)
    j_plan = j_wk.plan(x.shape, w.shape, pool=pool, pool_row_block=prb)
    t_plan = t_wk.plan(x.shape, w.shape, pool=pool, pool_row_block=prb)
    assert (t_plan.Cb, t_plan.ncb, t_plan.Kb, t_plan.nkb) == (
        j_plan.Cb, j_plan.ncb, j_plan.Kb, j_plan.nkb)
    if name.startswith("multi_cblock"):
        assert t_plan.ncb > 1
    ref = np.asarray(j_wk.conv2d_winograd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True, pool=pool,
        pool_row_block=prb, interpret=True))
    got = t_wk.conv2d_winograd(*(torch.from_numpy(a) for a in (x, w, b)),
                               relu=True, pool=pool,
                               pool_row_block=prb).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("route", list(ROUTES))
def test_reduced_apply_matches_jax(reduced, route):
    j_cfg, t_cfg, np_params, imgs = reduced
    j_cfg = dataclasses.replace(j_cfg, **ROUTES[route])
    t_cfg = dataclasses.replace(t_cfg, **ROUTES[route])
    ref = np.asarray(j_alexnet.apply(np_params, j_cfg, jnp.asarray(imgs)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    got = alexnet.apply(params, t_cfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, t_cfg.num_classes)
    _close(got, ref, route)


def test_reduced_abft_forward(reduced):
    """Armed reduced VGG: verdict 0 on clean slabs, logits equal to the
    unarmed forward's bit for bit, and the reference's verdict 0 too."""
    j_cfg, t_cfg, np_params, imgs = reduced
    cfg = dataclasses.replace(t_cfg, use_pallas=True)
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(imgs)
    plain = alexnet.apply(params, cfg, x)
    logits, sdc = alexnet.apply(params, dataclasses.replace(
        cfg, sdc_abft=True), x)
    assert int(sdc) == 0 and torch.equal(logits, plain)
    j_logits, j_sdc = j_alexnet.apply(np_params, dataclasses.replace(
        j_cfg, use_pallas=True, sdc_abft=True), jnp.asarray(imgs))
    assert int(j_sdc) == 0
    _close(logits.numpy(), np.asarray(j_logits))


@pytest.fixture
def exact_jax_exp2(monkeypatch):
    """The JAX package's BFP scales as exact powers of two (see
    ``tests/test_torch_bfp.py``), and its BFP matmul through its plain
    reference: its Pallas kernel in interpret mode does not compile on
    XLA's CPU for reduced VGG's fc8 (K = 24, exponent block 8; ROADMAP
    Queue 3)."""
    def exp2(v):
        v = jnp.asarray(v)
        return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                         jnp.round(v).astype(jnp.int32))
    jax.clear_caches()
    monkeypatch.setattr(jnp, "exp2", exp2)
    monkeypatch.setattr(j_bops, "bfp_matmul",
                        functools.partial(j_bops.bfp_matmul, pallas=False))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("flags", [dict(fc_bfp=True), dict(conv_bfp=True),
                                   dict(fc_bfp=True, conv_bfp=True)],
                         ids=["fc", "conv", "both"])
@pytest.mark.parametrize("route", ["direct", "pallas"])
def test_f32_bfp_matches_jax(reduced, exact_jax_exp2, route, flags):
    """f32 VGG under fc_bfp / conv_bfp is served, and matches the
    reference (the quantization ran: the logits differ from f32's)."""
    j_cfg, t_cfg, np_params, imgs = reduced
    change = {**ROUTES[route], **flags}
    ref = np.asarray(j_alexnet.apply(np_params, dataclasses.replace(
        j_cfg, **change), jnp.asarray(imgs)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    cfg = dataclasses.replace(t_cfg, **change)
    got = alexnet.apply(params, cfg, torch.from_numpy(imgs)).numpy()
    _close(got, ref, f"{route} {flags}")
    f32 = alexnet.apply(params, dataclasses.replace(
        cfg, fc_bfp=False, conv_bfp=False), torch.from_numpy(imgs)).numpy()
    assert not np.array_equal(got, f32)


def test_engine_serves_reduced_vgg_bit_equal_to_apply(reduced):
    """Groups of 1-4 requests through CnnEngine(max_batch=4) on route
    pallas: each request's logits equal ``apply`` on its served padded
    bucket, bit for bit, and the accounting balances."""
    _, t_cfg, np_params, _ = reduced
    cfg = dataclasses.replace(t_cfg, use_pallas=True)
    params = alexnet.params_from_numpy(np_params, device="cpu")
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=4), params=params,
                    device="cpu")
    rng = np.random.default_rng(3)
    reqs = [ImageRequest(image=rng.standard_normal(
        (cfg.image_size, cfg.image_size, 3)).astype(np.float32))
        for _ in range(7)]
    i = 0
    for size in (3, 1, 2, 1):
        for r in reqs[i:i + size]:
            eng.submit(r)
        i += size
        eng.step()
    eng.run_until_done()
    assert all(r.done for r in reqs)
    by_uid = {r.uid: r for r in reqs}
    for grp in {r.served_group for r in reqs}:
        bucket = by_uid[grp[0]].served_bucket
        x = np.zeros((bucket, cfg.image_size, cfg.image_size, 3),
                     np.float32)
        for row, uid in enumerate(grp):
            x[row] = by_uid[uid].image
        ref = alexnet.apply(params, cfg, torch.from_numpy(x)).numpy()
        for row, uid in enumerate(grp):
            assert np.array_equal(by_uid[uid].logits, ref[row])
    acc = eng.stats()["accounting"]
    assert acc["balanced"] and acc["completed"] == len(reqs)


def test_launcher_serves_vgg16_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "vgg16", "--requests", "3", "--route", "pallas",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "conv4=cuda-winograd" in out     # the reduced VGG's last conv
    assert "vgg16 (float32): completed 3/3" in out and "balanced=yes" in out
