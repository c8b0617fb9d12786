"""Training the image models: the port's ``alexnet.loss_fn`` differentiated
with autograd against ``jax.value_and_grad`` of the JAX package's, on the
CPU.

The JAX package's parameters are carried into the port with
``alexnet.params_from_numpy``; images and labels are made with numpy from
a seed.  Tolerances: the loss within 1e-5 and every gradient leaf within
1e-4 * max|g_ref| + 1e-7 in f32; in bf16 within 3 bf16 steps of
max|g_ref| (2.4e-2), except reduced VGG-16 on route ``winograd``, held to
1e-1 (read 7.08e-2): there the reference's own bf16 gradient moves by
19-55% of max|g| when the images move by 1e-4 of themselves (a few inputs
round to the neighbouring bf16 value and a pool's argmax moves), so two
f32 summation orders part by more than 3 bf16 steps; under ``conv_bfp``
every conv filter's gradient is exactly zero in both packages (the
filters pass through ``round``).
Three AdamW steps are held to the reference's jitted step of
``examples/alexnet_winograd.py`` at rtol 1e-4 / atol 1e-5.
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
from repro.optim import adamw_step as j_adamw_step  # noqa: E402
from repro.optim import init_state as j_init_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import synthetic_images  # noqa: E402
from repro_torch.kernels.bfp_matmul.ops import bfp_linear  # noqa: E402
from repro_torch.kernels.conv.dma import WeightStager  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn.conv import ConvSpec, dispatch_conv  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402
from repro_torch.optim import adamw_step, init_state  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest)

ARCHS = ("alexnet", "vgg16")
ROUTES = {"winograd": {}, "direct": {"use_winograd": False}}
MODES = {"f32": {}, "bf16": {"dtype": "bfloat16"},
         "conv_bfp": {"conv_bfp": True}}
# the config, the word its error names, the stage that refuses it
RAISING = {"pallas": ({"use_pallas": True}, "route 'pallas'", "features"),
           "fc_bfp": ({"fc_bfp": True}, "fc_bfp", "classifier"),
           "sdc_abft": ({"sdc_abft": True}, "sdc_abft", "features")}
TOL_F32 = 1e-4
TOL_BF16 = 3 * 2.0 ** -7          # 3 bf16 steps of max|g_ref|: 2.34e-2
# the case whose reference gradient moves by more than that for inputs a
# few bf16 roundings apart (module docstring)
TOL_BF16_CASE = {("vgg16", "winograd"): 1e-1}
BATCH = 4
# the reference under jit, as its example trains (eager, its
# value_and_grad takes about 10 s a case on the CPU)
_j_init = jax.jit(j_alexnet.init, static_argnums=1)
_j_value_and_grad = jax.jit(jax.value_and_grad(j_alexnet.loss_fn,
                                               has_aux=True),
                            static_argnums=1)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced model in both packages: the reference's f32 and bf16
    parameters as f32 numpy, a batch of images and labels."""
    arch = request.param
    j_cfg = j_get_config(arch).reduced()
    np_params = {dt: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        _j_init(jax.random.PRNGKey(0), dataclasses.replace(j_cfg, dtype=dt)))
        for dt in ("float32", "bfloat16")}
    rng = np.random.default_rng(7)
    batch = {"images": rng.standard_normal(
        (BATCH, j_cfg.image_size, j_cfg.image_size, 3)).astype(np.float32),
        "labels": rng.integers(0, j_cfg.num_classes, BATCH).astype(np.int32)}
    return arch, j_cfg, get_config(arch).reduced(), np_params, batch


def _port_params(np_params, dtype, *, grad=True):
    params = alexnet.params_from_numpy(np_params[dtype], device="cpu",
                                       dtype=dtype)
    for sub in params.values():
        for v in sub.values():
            v.requires_grad_(grad)
    return params


def _port_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def _port_value_and_grad(params, cfg, batch):
    leaves = tree_leaves(params)
    loss, aux = alexnet.loss_fn(params, cfg, batch)
    return loss, aux, torch.autograd.grad(loss, leaves)


def _ref_value_and_grad(np_params, j_cfg, batch):
    dt = jnp.dtype(j_cfg.dtype)
    j_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dt),
                                      np_params[j_cfg.dtype])
    (loss, aux), g = _j_value_and_grad(
        j_params, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, aux, g


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_gradients_match_reference(model, route, mode, record_property):
    """The loss and every gradient leaf against the reference's; the
    worst leaf's error over its max|g_ref| is recorded (``--junitxml``)
    as ``worst_rel_err``, beside ``allowed`` (the bound over max|g_ref|);
    in bf16 also ``ref_moved``, the most the reference's own gradient
    moves, over max|g_ref|, for the images moved by 1e-4 of themselves."""
    arch, j_cfg, t_cfg, np_params, batch = model
    kw = {**ROUTES[route], **MODES[mode]}
    j_cfg = dataclasses.replace(j_cfg, **kw)
    t_cfg = dataclasses.replace(t_cfg, **kw)
    j_loss, j_aux, j_g = _ref_value_and_grad(np_params, j_cfg, batch)
    if mode == "bf16":
        # the reference on images moved by 1e-4 of themselves, under a
        # bf16 step: a few inputs round to the neighbouring bf16 value;
        # recorded, not used in the bound
        _, _, j_moved = _ref_value_and_grad(np_params, j_cfg, {
            **batch, "images": batch["images"] * np.float32(1 + 1e-4)})
    params = _port_params(np_params, t_cfg.dtype)
    loss, aux, grads = _port_value_and_grad(params, t_cfg, _port_batch(batch))
    assert loss.grad_fn is not None
    assert float(aux["accuracy"]) == pytest.approx(float(j_aux["accuracy"]))
    if mode != "bf16":
        tol = TOL_F32
        assert loss.item() == pytest.approx(float(j_loss), rel=1e-5,
                                            abs=1e-5)
    else:
        tol = TOL_BF16_CASE.get((arch, route), TOL_BF16)
        assert (abs(loss.item() - float(j_loss))
                <= TOL_BF16 * abs(float(j_loss)))
    names = [(layer, k) for layer in params for k in params[layer]]
    worst, moved = (0.0, None), 0.0
    for (layer, k), g in zip(names, grads):
        ref = _f32(j_g[layer][k])
        got = g.float().numpy()
        assert got.shape == ref.shape, (layer, k)
        assert g.dtype == params[layer][k].dtype
        if mode == "conv_bfp" and layer.startswith("conv") and k == "w":
            # the quantized filters' gradient is round's: exactly zero,
            # in both packages
            assert not ref.any() and not got.any(), (layer, k)
            continue
        scale = np.abs(ref).max()
        assert scale > 0, (layer, k)
        err = np.abs(got - ref).max()
        if mode == "bf16":
            moved = max(moved, float(
                np.abs(_f32(j_moved[layer][k]) - ref).max() / scale))
        if worst[1] is None or err / scale > worst[0]:
            worst = (float(err / scale), f"{layer}.{k}")
        assert err <= tol * scale + 1e-7, (arch, route, mode, layer, k,
                                           err / scale)
    record_property("worst_rel_err", worst[0])
    record_property("worst_leaf", worst[1])
    record_property("allowed", float(tol))
    if mode == "bf16":
        record_property("ref_moved", moved)


def _state_from_reference(j_state):
    """The port's AdamW state holding the reference's state's values."""
    host = jax.tree_util.tree_map(np.asarray, j_state)
    tensors = {key: alexnet.params_from_numpy(host[key], device="cpu")
               for key in ("params", "m", "v")}
    for v in tree_leaves(tensors["params"]):
        v.requires_grad_()
    return {"step": torch.tensor(int(host["step"]), dtype=torch.int32),
            **tensors}


@pytest.mark.parametrize("route", list(ROUTES))
def test_three_adamw_steps_match_reference(model, route):
    """Three steps of ``examples/alexnet_winograd.py``'s jitted step
    (``value_and_grad`` of ``loss_fn``, AdamW at lr 3e-3) on
    ``synthetic_images``: each step's loss and grad norm, the params after
    it at rtol 1e-4 / atol 1e-5.  Every step's forward packs from the
    weights the previous step wrote.

    Route ``direct`` runs free, each package from its own state.  On route
    ``winograd`` the filter taps whose exact gradient is 0 (at these
    reduced maps, taps that see only padding or dead units: 0 on route
    ``direct``) come out of the Winograd transforms as float noise of about
    1e-9 in both packages, and AdamW's first step turns that noise into
    steps of up to lr, of either sign; the runs part from the second step
    on.  There each step starts from the reference's state, and the
    elements whose reference gradient is under 1e-6 of its leaf's max are
    held to 2 lr."""
    arch, j_cfg, t_cfg, np_params, _ = model
    j_cfg = dataclasses.replace(j_cfg, **ROUTES[route])
    t_cfg = dataclasses.replace(t_cfg, **ROUTES[route])
    lr = 3e-3

    @jax.jit
    def step(state, batch):
        (loss, m), g = jax.value_and_grad(j_alexnet.loss_fn, has_aux=True)(
            state["params"], j_cfg, batch)
        state, om = j_adamw_step(state, g, lr=lr)
        return state, {**m, **om}, g

    j_state = j_init_state(jax.tree_util.tree_map(jnp.asarray,
                                                  np_params["float32"]))
    state = init_state(_port_params(np_params, "float32"))
    data = synthetic_images(batch=16, image_size=t_cfg.image_size,
                            num_classes=t_cfg.num_classes, seed=0, steps=3)
    for b in data:
        if route == "winograd":
            state = _state_from_reference(j_state)
        j_state, j_m, j_g = step(j_state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        loss, _, grads = _port_value_and_grad(state["params"], t_cfg,
                                              _port_batch(b))
        _, om = adamw_step(state, grads, lr=lr)
        assert loss.item() == pytest.approx(float(j_m["loss"]), rel=1e-5)
        assert float(om["grad_norm"]) == pytest.approx(
            float(j_m["grad_norm"]), rel=1e-4)
        for layer, sub in state["params"].items():
            for k, v in sub.items():
                got = v.detach().numpy()
                want = np.asarray(j_state["params"][layer][k])
                g = np.abs(np.asarray(j_g[layer][k]))
                noise = g <= 1e-6 * g.max()
                assert np.abs(got - want)[noise].max(initial=0) <= 2 * lr
                np.testing.assert_allclose(
                    got[~noise], want[~noise], rtol=1e-4, atol=1e-5,
                    err_msg=f"{arch} {route} {layer}.{k}")
    assert int(state["step"]) == int(j_state["step"]) == 3


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_carries_every_gradient(arch, mode):
    """The loss has a ``grad_fn`` and every leaf, the conv filters among
    them, gets a gradient tensor of its own shape (zero only for the
    quantized filters of ``conv_bfp``)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **MODES[mode])
    params = alexnet.init(0, cfg, device="cpu")
    leaves = tree_leaves(params)
    for v in leaves:
        v.requires_grad_()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    loss, _ = alexnet.loss_fn(params, cfg, {
        "images": images, "labels": torch.tensor([1, 2])})
    assert loss.grad_fn is not None
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for (layer, sub) in params.items():
        for k, v in sub.items():
            g = grads[[id(x) for x in leaves].index(id(v))]
            assert g is not None and g.shape == v.shape, (layer, k)
            assert bool(torch.isfinite(g).all()), (layer, k)
            if not (mode == "conv_bfp" and layer.startswith("conv")
                    and k == "w"):
                assert bool(g.any()), (layer, k)


@pytest.mark.parametrize("name", list(RAISING))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_backward_raises(arch, name):
    """Route ``pallas``, ``fc_bfp`` and ``sdc_abft`` raise at the forward
    when a gradient is wanted, naming the reason, where the reference's
    gradient fails too: the conv kernels' entry and the armed
    ``features`` in the features, the BFP matmul's entry in the
    classifier, on features that require grad; under ``torch.no_grad()``
    they serve."""
    kw, reason, stage = RAISING[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    params = alexnet.init(0, cfg, device="cpu")
    for v in tree_leaves(params):
        v.requires_grad_()
    images = torch.zeros((1, cfg.image_size, cfg.image_size, 3))
    batch = {"images": images, "labels": torch.tensor([0])}
    with pytest.raises(ValueError, match=reason):
        alexnet.loss_fn(params, cfg, batch)
    with pytest.raises(ValueError, match=reason):
        if stage == "features":
            alexnet.features(params, cfg, images)
        else:
            alexnet.classifier(params, cfg, torch.zeros(
                (1, alexnet.fc_input_dim(cfg)), requires_grad=True))
    with torch.no_grad():
        out = alexnet.apply(params, cfg, images)
    logits = out[0] if cfg.sdc_abft else out
    assert logits.grad_fn is None and logits.shape == (1, cfg.num_classes)


def test_cuda_kernel_route_refuses_gradients():
    """``dispatch_conv`` refuses to run a CUDA kernel (its plain version
    on the CPU) on a filter that requires grad with grad mode on: the
    output would carry no gradient."""
    spec = ConvSpec(kernel=3, relu=True).with_route("pallas")
    x = torch.randn(1, 8, 8, 4)
    w = torch.randn(3, 3, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        dispatch_conv(spec, x, w)
    with torch.no_grad():
        assert dispatch_conv(spec, x, w).shape == (1, 8, 8, 8)


@pytest.mark.parametrize("grad", ("x", "w"))
def test_bfp_matmul_refuses_gradients(grad):
    """Kernel 4's entry refuses an input that requires grad with grad
    mode on (its plain version on the CPU): the output would carry no
    gradient.  Under ``torch.no_grad()`` it computes."""
    x = torch.randn(4, 64, requires_grad=grad == "x")
    w = torch.randn(64, 8, requires_grad=grad == "w")
    with pytest.raises(ValueError, match="fc_bfp"):
        bfp_linear(x, w)
    with torch.no_grad():
        assert bfp_linear(x, w).shape == (4, 8)


def test_training_forward_refuses_earlier_slabs(model):
    """A differentiable forward packs from the live weights: a stager that
    staged slabs in an earlier call, or packed serving slabs, are
    refused."""
    _, _, t_cfg, np_params, batch = model
    cfg = dataclasses.replace(t_cfg, conv_bfp=True)
    params = _port_params(np_params, "float32")
    images = _port_batch(batch)["images"]
    stager = WeightStager()
    alexnet.apply(params, cfg, images, stager=stager)
    assert stager.misses > 0
    with pytest.raises(ValueError, match="live weights"):
        alexnet.apply(params, cfg, images, stager=stager)
    packed = alexnet.pack_serving_slabs(params, cfg, BATCH)
    with pytest.raises(ValueError, match="live weights"):
        alexnet.apply(params, cfg, images, packed=packed)


@pytest.mark.parametrize("route", ("pallas", "winograd"))
def test_serving_builds_no_graph(model, route):
    """Params that do not require grad give logits without a
    ``grad_fn``; ``CnnEngine``'s logits are bit-equal to ``apply``'s at
    the served bucket, also on params that require grad (the engine
    serves under ``torch.no_grad()``)."""
    _, _, t_cfg, np_params, batch = model
    cfg = dataclasses.replace(t_cfg, use_pallas=route == "pallas")
    params = _port_params(np_params, "float32", grad=False)
    images = _port_batch(batch)["images"]
    want = alexnet.apply(params, cfg, images)
    assert want.grad_fn is None
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=BATCH),
                    params=_port_params(np_params, "float32"), device="cpu")
    reqs = [ImageRequest(image=im) for im in batch["images"]]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert np.array_equal(np.stack([r.logits for r in reqs]), want.numpy())
