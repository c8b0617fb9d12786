"""Reduced AlexNet of the PyTorch port against the JAX package, on the CPU.

The JAX package's parameters (``repro.models.alexnet.init``) are carried
into the port with ``params_from_numpy``; images are made with numpy from
a seed.  Logits must agree at rtol 1e-4 and atol 1e-4 * max|logit| (both
float32; the conv routes sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.conv.dma import WeightStager  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402

ROUTES = {"direct": dict(use_winograd=False),
          "winograd": dict(),
          "pallas": dict(use_pallas=True)}


@pytest.fixture(scope="module")
def reduced():
    """Reduced config in both packages, the JAX params as numpy, images."""
    j_cfg = j_get_config("alexnet").reduced()
    np_params = jax.tree_util.tree_map(
        np.asarray, j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, j_cfg.in_channels)
    ).astype(np.float32)
    return j_cfg, get_config("alexnet").reduced(), np_params, imgs


def test_configs_mean_the_same():
    for full in (True, False):
        j_cfg, t_cfg = j_get_config("alexnet"), get_config("alexnet")
        if not full:
            j_cfg, t_cfg = j_cfg.reduced(), t_cfg.reduced()
        j_fields = dataclasses.asdict(j_cfg)
        assert dataclasses.asdict(t_cfg) == j_fields
        assert alexnet.fc_input_dim(t_cfg) == j_alexnet._fc_input_dim(j_cfg)


@pytest.mark.parametrize("route", list(ROUTES))
def test_reduced_apply_matches_jax(reduced, route):
    j_cfg, t_cfg, np_params, imgs = reduced
    j_cfg = dataclasses.replace(j_cfg, **ROUTES[route])
    t_cfg = dataclasses.replace(t_cfg, **ROUTES[route])
    ref = np.asarray(j_alexnet.apply(np_params, j_cfg, jnp.asarray(imgs)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    got = alexnet.apply(params, t_cfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape == (2, t_cfg.num_classes)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=route)


def test_features_flatten_in_nhwc_order(reduced):
    """fc6 reads conv5's map flattened as (h, w, c): the port's features
    equal the JAX package's element for element, not only as a set.  At
    99 px conv5's map is 2x2, so the two orders differ."""
    j_cfg, t_cfg, np_params, _ = reduced
    j_cfg = dataclasses.replace(j_cfg, image_size=99)
    t_cfg = dataclasses.replace(t_cfg, image_size=99)
    imgs = np.random.default_rng(1).standard_normal(
        (2, 99, 99, 3)).astype(np.float32)
    ref = np.asarray(j_alexnet.features(np_params, j_cfg, jnp.asarray(imgs)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    got = alexnet.features(params, t_cfg, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    hw = alexnet._feature_hw(t_cfg)
    assert hw == 2
    nchw = got.reshape(2, hw, hw, -1).transpose(0, 3, 1, 2)
    assert not np.allclose(nchw.reshape(2, -1), ref, rtol=1e-4, atol=1e-5)


def test_loss_fn_matches_jax(reduced):
    j_cfg, t_cfg, np_params, imgs = reduced
    labels = np.array([3, 7])
    j_loss, j_aux = j_alexnet.loss_fn(np_params, j_cfg, {
        "images": jnp.asarray(imgs), "labels": jnp.asarray(labels)})
    params = alexnet.params_from_numpy(np_params, device="cpu")
    t_loss, t_aux = alexnet.loss_fn(params, t_cfg, {
        "images": torch.from_numpy(imgs), "labels": torch.from_numpy(labels)})
    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(t_aux["accuracy"]) == float(j_aux["accuracy"])


def test_layer_routes_full_config():
    """The default serving config on route pallas runs exactly the three
    ported kernels: conv1/conv2 direct, conv3-conv5 Winograd."""
    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    assert alexnet.layer_routes(cfg) == [
        ("conv1", "cuda-direct"), ("conv2", "cuda-direct"),
        ("conv3", "cuda-winograd"), ("conv4", "cuda-winograd"),
        ("conv5", "cuda-winograd")]
    j_cfg = dataclasses.replace(j_get_config("alexnet"), use_pallas=True)
    assert [(n, k.replace("pallas-", "cuda-"))
            for n, k in j_alexnet.layer_routes(j_cfg)] == \
        alexnet.layer_routes(cfg)


def test_init_matches_the_jax_scheme():
    """Same shapes and the same truncated-normal scale rule as the JAX
    package (the draws differ: torch.Generator vs jax.random)."""
    cfg = get_config("alexnet").reduced()
    p = alexnet.init(0, cfg, device="cpu")
    j_p = j_alexnet.init(jax.random.PRNGKey(0),
                         j_get_config("alexnet").reduced())
    assert p.keys() == j_p.keys()
    for layer in p:
        for k in ("w", "b"):
            assert tuple(p[layer][k].shape) == j_p[layer][k].shape
        w = p[layer]["w"]
        fan_in = w[..., 0].numel()
        assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 + 1e-6
        assert not torch.count_nonzero(p[layer]["b"])
    again = alexnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(p[n]["w"], again[n]["w"]) for n in p)


def test_packed_and_staged_forwards_are_bit_equal(reduced):
    """Pack-once slabs, a persistent stager and a fresh forward give the
    same bits; the stager packs each layer once across forwards."""
    _, t_cfg, np_params, imgs = reduced
    cfg = dataclasses.replace(t_cfg, use_pallas=True)
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(imgs)
    fresh = alexnet.apply(params, cfg, x)
    packed = alexnet.pack_serving_slabs(params, cfg, x.shape[0])
    assert [packed[f"conv{i}"].kernel for i in range(1, 6)] == \
        ["cuda-direct"] * 2 + ["cuda-winograd"] * 3
    assert torch.equal(alexnet.apply(params, cfg, x, packed=packed), fresh)
    stager = WeightStager()
    for _ in range(2):
        assert torch.equal(alexnet.apply(params, cfg, x, stager=stager),
                           fresh)
    assert stager.misses == 5 and stager.hits >= 5


def test_tuned_plans_are_refused_not_ignored():
    """Plans tuned for the TPU kernels never steer the CUDA kernels: the
    reference's cache (keyed ``cpu-interpret``) loads nothing, on the CPU
    as on the card, and neither does the port's cache, tuned on a card, on
    the CPU."""
    from repro_torch.core import autotune
    cfg = get_config("alexnet")
    ref_cache = autotune.PLAN_DIR / "alexnet.json"
    assert ref_cache.exists()
    for c in (cfg, cfg.reduced()):
        for batch in (2, 8):
            assert alexnet.load_tuned_plans(c, batch, device="cpu") == {}
            assert alexnet.load_tuned_plans(c, batch, path=ref_cache,
                                            device="cpu") == {}


def test_unknown_arch_is_refused():
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("resnet50")
