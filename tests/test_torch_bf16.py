"""bf16 image models in the PyTorch port against the JAX package, on the
CPU.

The reference's bf16 AlexNet and VGG-16 keep bf16 activations and
parameters; its conv kernels widen them to f32, compute in f32 and round
each layer's output to bf16 once; its direct slabs are bf16 and its
Winograd slabs f32 (G w G^T is never cast back).  The port packs the same
dtypes, and its kernels' plain versions (the CPU side of each wrapper) do
the same arithmetic: held to the JAX kernels in bf16 interpret mode within
one bf16 step (|diff| <= 2**-7 * |ref| + 1e-5 * max|ref|: both round f32
values that differ by f32 noise).  Reduced bf16 models, served or not,
within 5e-2 * max|logit| of the reference's (its own bf16 bound,
``tests/test_serve_fleet.py``).  Parameters cross between the packages as
float32 numpy arrays, exact for bf16 values.  BFP in bf16 is
``tests/test_torch_bfp_bf16.py``'s.  Every input is made with numpy from a
seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.conv import direct as j_direct  # noqa: E402
from repro.kernels.conv import winograd as j_winograd  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro.nn.pooling import LrnParams as JLrn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv import direct, dma, winograd  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn.pooling import LrnParams  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest)

BF16_STEP = 2.0 ** -7
TOL_MODEL = 5e-2
ARCHS = ["alexnet", "vgg16"]

# (name, kind, kw, r, B, H, c_in, c_out): reduced AlexNet's five layers and
# two VGG-shaped ones (C_in = 3 on a Winograd layer, a 2x2/2 pool)
LAYERS = [
    ("conv1", "direct", dict(stride=4, padding="VALID", lrn=True,
                             pool=(3, 2)), 11, 2, 35, 3, 16),
    ("conv2", "direct", dict(groups=2, lrn=True, pool=(3, 2)),
     5, 2, 13, 16, 32),
    ("conv3", "winograd", dict(), 3, 2, 13, 32, 48),
    ("conv4", "winograd", dict(groups=2), 3, 2, 13, 48, 48),
    ("conv5", "winograd", dict(groups=2, pool=(3, 2)), 3, 2, 13, 48, 32),
    ("vgg_c3", "winograd", dict(), 3, 2, 16, 3, 8),
    ("vgg_pool2", "winograd", dict(pool=(2, 2)), 3, 2, 14, 16, 24),
]


def _inputs(seed, B, H, c_in, c_out, r, groups):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((r, r, c_in // groups, c_out))
         * (r * r * c_in / groups) ** -0.5).astype(np.float32)
    b = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    return x, w, b


def _bf16(a):
    """numpy f32 -> torch bf16 (round to nearest even, as JAX rounds)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


def _within_one_step(got, ref):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape
    excess = np.abs(got - ref) - (BF16_STEP * np.abs(ref)
                                  + 1e-5 * np.abs(ref).max())
    assert excess.max() <= 0, excess.max()


def _call(kind, lib, kw, x, w, b, **extra):
    kw = dict(kw)
    if kw.pop("lrn", False):
        kw["lrn"] = JLrn() if lib == "jax" else LrnParams()
    if lib == "jax":
        mod = j_direct if kind == "direct" else j_winograd
        fn = (mod.conv2d_direct if kind == "direct"
              else mod.conv2d_winograd)
        return fn(x, w, b, relu=True, interpret=True, **kw, **extra)
    fn = (direct.conv2d_direct if kind == "direct"
          else winograd.conv2d_winograd)
    return fn(x, w, b, relu=True, **kw, **extra)


@pytest.mark.parametrize("name,kind,kw,r,B,H,c_in,c_out", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_plain_kernels_in_bf16_match_jax(name, kind, kw, r, B, H, c_in,
                                         c_out):
    """Kernels 1-3's plain versions on bf16 x, filters and bias: a bf16
    output within one bf16 step of the JAX kernel's in interpret mode."""
    x, w, b = _inputs(1, B, H, c_in, c_out, r, kw.get("groups", 1))
    ref = _call(kind, "jax", kw, *(jnp.asarray(a).astype(jnp.bfloat16)
                                   for a in (x, w, b)))
    got = _call(kind, "torch", kw, *(_bf16(a) for a in (x, w, b)))
    assert got.dtype is torch.bfloat16 and ref.dtype == jnp.bfloat16
    _within_one_step(got, ref)


@pytest.mark.parametrize("name,kind,kw,r,B,H,c_in,c_out", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_packed_slab_dtypes_equal_the_references(name, kind, kw, r, B, H,
                                                 c_in, c_out):
    """A bf16 layer's slab: bf16 for the direct kernel, f32 for the
    Winograd kernels (the reference keeps G w G^T in f32), armed or not;
    the values equal the reference's slab within its f32 transform
    noise."""
    _, w, _ = _inputs(2, B, H, c_in, c_out, r, kw.get("groups", 1))
    kwp = {k: v for k, v in kw.items() if k != "lrn"}
    if kind == "winograd" and kw.get("lrn"):
        kwp["lrn"] = LrnParams()
    t_mod, j_mod = ((direct, j_direct) if kind == "direct"
                    else (winograd, j_winograd))
    shape = (B, H, H, c_in)
    for armed in (False, True):
        tp = t_mod.plan(shape, w.shape, checksum=armed, **kwp)
        jp = j_mod.plan(shape, w.shape, checksum=armed, **{
            k: (JLrn() if k == "lrn" else v) for k, v in kwp.items()})
        t_slab = t_mod.pack_weights(_bf16(w), tp)
        j_slab = j_mod.pack_weights(jnp.asarray(w).astype(jnp.bfloat16), jp)
        want = torch.bfloat16 if kind == "direct" else torch.float32
        assert t_slab.dtype is want
        assert str(j_slab.dtype) == str(want).removeprefix("torch.")
        assert tuple(t_slab.shape) == j_slab.shape
        if armed:
            assert int(dma.checksum_mismatches(t_slab)) == 0
            t_slab = t_slab[..., :-1, :]
            j_slab = j_slab[..., :-1, :]
        np.testing.assert_allclose(_f32(t_slab), _f32(j_slab), rtol=1e-6,
                                   atol=1e-6)


def test_bf16_kernel_rule_holds_for_the_plain_versions():
    """The rule the card holds kernels 2-3 and kernel 1 on an f32 slab to,
    on kernels 1-3's plain versions: a bf16 call equals the f32 call on
    the widened inputs, rounded once."""
    for name, kind, kw, r, B, H, c_in, c_out in LAYERS:
        x, w, b = (_bf16(a) for a in _inputs(
            3, B, H, c_in, c_out, r, kw.get("groups", 1)))
        got = _call(kind, "torch", kw, x, w, b)
        want = _call(kind, "torch", kw, x.float(), w.float(), b.float())
        assert torch.equal(got, want.to(torch.bfloat16)), name


def test_armed_bf16_direct_slab_counts_flips():
    """An armed bf16 direct slab: 16-bit checksum lanes; a clean slab gives
    verdict 0 and the unarmed output, each single-bit flip verdict 1."""
    name, kind, kw, r, B, H, c_in, c_out = LAYERS[1]
    x, w, b = (_bf16(a) for a in _inputs(4, B, H, c_in, c_out, r, 2))
    p = direct.plan(tuple(x.shape), tuple(w.shape), groups=2, pool=(3, 2),
                    checksum=True)
    armed = direct.pack_weights(w, p)
    assert armed.dtype is torch.bfloat16
    base = _call(kind, "torch", kw, x, w, b)
    y, v = _call(kind, "torch", kw, x, w, b, w_packed=armed, checksum=True)
    assert torch.equal(y, base) and int(v) == 0
    rng = np.random.default_rng(0)
    for bit in rng.integers(0, armed.numel() * 16, size=12):
        flat = armed.clone().view(-1).view(torch.uint8)
        flat[int(bit) // 8] ^= 1 << (int(bit) % 8)
        bad = flat.view(torch.bfloat16).view(armed.shape)
        _, v = _call(kind, "torch", kw, x, w, b, w_packed=bad,
                     checksum=True)
        assert int(v) == int(dma.checksum_mismatches(bad)) == 1


def test_cuda_inputs_take_per_tensor_dtypes():
    """What the CUDA wrappers accept before a launch: x f32 or bf16, the
    bias in x's dtype, the direct slab in x's dtype, the Winograd slab
    f32; anything else raises, naming the tensor."""
    x16, x32 = torch.zeros((1, 4, 4, 2), dtype=torch.bfloat16), \
        torch.zeros((1, 4, 4, 2))
    b16, b32 = torch.zeros((2,), dtype=torch.bfloat16), torch.zeros((2,))
    s16, s32 = torch.zeros((3,), dtype=torch.bfloat16), torch.zeros((3,))
    direct.check_cuda_inputs("conv_direct", x16, s16, b16, 2)
    direct.check_cuda_inputs("conv_direct", x32, s32, b32, 2)
    direct.check_cuda_inputs("conv_winograd", x16, s32, b16, 2,
                             slab_dtype=torch.float32)
    for args, kw, what in (
            ((x16, s32, b16), {}, "slab"),
            ((x16, s16, b32), {}, "bias"),
            ((x16, s16, b16), dict(slab_dtype=torch.float32), "slab"),
            ((x32.half(), s32, b32), {}, "float32 or bfloat16")):
        with pytest.raises(ValueError, match=what):
            direct.check_cuda_inputs("conv", *args, 2, **kw)


def test_conv_args_carry_the_element_types():
    x = torch.zeros((1, 35, 35, 3), dtype=torch.bfloat16)
    p = direct.plan(tuple(x.shape), (11, 11, 3, 16), stride=4,
                    padding="VALID")
    a = direct.conv_args(x, p, relu=True, lrn=None, pool=None, PT=1,
                         pad=(0, 0), out_hw=(7, 7))
    assert (a.xdt, a.sdt) == (1, 1)
    a = direct.conv_args(x, p, relu=True, lrn=None, pool=None, PT=1,
                         pad=(0, 0), out_hw=(7, 7), slab_dtype=torch.float32)
    assert (a.xdt, a.sdt) == (1, 0)
    assert build.DTYPE_CODES == {"float32": 0, "bfloat16": 1}
    names = [f[0] for f in build.ConvArgs._fields_]
    assert names[-3:] == ["xdt", "sdt", "verdict"]


# ---------------------------------------------------------------------------
# models and the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def reduced16(request):
    """A reduced bf16 model in both packages with the reference's bf16
    parameters (as f32 numpy), and two numpy images."""
    arch = request.param
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="bfloat16")
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    np_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    imgs = np.random.default_rng(5).standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, 3)).astype(np.float32)
    return arch, j_cfg, t_cfg, np_params, imgs


def _j_params(np_params):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), np_params)


def _close_model(got, ref):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= TOL_MODEL * scale


@pytest.mark.parametrize("route", ["direct", "pallas"])
def test_reduced_bf16_apply_matches_jax(reduced16, route):
    arch, j_cfg, t_cfg, np_params, imgs = reduced16
    kw = (dict(use_winograd=False) if route == "direct"
          else dict(use_pallas=True))
    ref = j_alexnet.apply(_j_params(np_params),
                          dataclasses.replace(j_cfg, **kw),
                          jnp.asarray(imgs))
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    assert all(v.dtype is torch.bfloat16 for sub in params.values()
               for v in sub.values())
    got = alexnet.apply(params, dataclasses.replace(t_cfg, **kw),
                        torch.from_numpy(imgs))
    assert got.dtype is torch.bfloat16
    _close_model(got, ref)


def test_bf16_slabs_of_the_served_models(reduced16):
    """pack_serving_slabs in bf16: each layer's slab dtype is the
    reference's."""
    arch, j_cfg, t_cfg, np_params, _ = reduced16
    j_packed = j_alexnet.pack_serving_slabs(
        _j_params(np_params), dataclasses.replace(j_cfg, use_pallas=True), 2)
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    packed = alexnet.pack_serving_slabs(
        params, dataclasses.replace(t_cfg, use_pallas=True), 2)
    assert packed.keys() == j_packed.keys()
    for name, pw in packed.items():
        assert str(pw.data.dtype).removeprefix("torch.") == \
            str(j_packed[name].data.dtype), name
        assert pw.kernel == j_packed[name].kernel.replace("pallas-", "cuda-")
    kinds = {pw.data.dtype for pw in packed.values()}
    assert kinds == ({torch.bfloat16, torch.float32} if arch == "alexnet"
                     else {torch.float32})


def test_bf16_abft_forward(reduced16):
    """Armed bf16 forward on route pallas: verdict 0, logits equal to the
    unarmed forward bit for bit."""
    _, _, t_cfg, np_params, imgs = reduced16
    cfg = dataclasses.replace(t_cfg, use_pallas=True)
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    x = torch.from_numpy(imgs)
    plain = alexnet.apply(params, cfg, x)
    logits, sdc = alexnet.apply(params, dataclasses.replace(
        cfg, sdc_abft=True), x)
    assert int(sdc) == 0 and torch.equal(logits, plain)


def test_staging_buffer_uses_config_dtype(reduced16):
    """The engine stages the model's dtype (a bf16 model stages bf16) and
    serves within the bf16 bound of the reference's apply on the same
    parameters (a port of the reference's test of the same name)."""
    arch, j_cfg, t_cfg, np_params, imgs = reduced16
    f32 = get_config(arch).reduced()
    eng32 = CnnEngine(f32, CnnServeConfig(max_batch=2), seed=0, device="cpu")
    assert eng32._buf_dtype is torch.float32
    cfg16 = dataclasses.replace(t_cfg, use_pallas=True)
    params = alexnet.params_from_numpy(np_params, device="cpu",
                                       dtype="bfloat16")
    eng16 = CnnEngine(cfg16, CnnServeConfig(max_batch=2), params=params,
                      device="cpu")
    assert eng16._buf_dtype is torch.bfloat16
    staged = []
    put = eng16._put
    eng16._put = lambda src: staged.append(src.dtype) or put(src)
    reqs = [ImageRequest(image=im) for im in imgs]
    for r in reqs:
        eng16.submit(r)
    eng16.run_until_done()
    assert staged == [torch.bfloat16] and all(r.done for r in reqs)
    got = np.stack([r.logits for r in reqs])
    assert got.dtype == np.float32
    ref = j_alexnet.apply(_j_params(np_params), dataclasses.replace(
        j_cfg, use_pallas=True), jnp.asarray(imgs))
    _close_model(got, ref)
    # bit-equal to the port's own apply at the served bucket
    want = alexnet.apply(params, cfg16, torch.from_numpy(imgs)).float()
    assert np.array_equal(got, want.numpy())


def test_bf16_params_cross_numpy_as_f32(reduced16):
    """bf16 parameters leave as float32 numpy (numpy has no bf16) and come
    back bit for bit; init draws in f32 and rounds to the config's
    dtype."""
    _, _, t_cfg, _, _ = reduced16
    p = alexnet.init(0, t_cfg, device="cpu")
    p32 = alexnet.init(0, dataclasses.replace(t_cfg, dtype="float32"),
                       device="cpu")
    host = alexnet.params_to_numpy(p)
    back = alexnet.params_from_numpy(host, device="cpu", dtype="bfloat16")
    for layer in p:
        for k in p[layer]:
            assert host[layer][k].dtype == np.float32
            assert torch.equal(back[layer][k], p[layer][k])
            assert torch.equal(p[layer][k], p32[layer][k].to(torch.bfloat16))


def test_launcher_serves_bf16_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "alexnet", "--dtype", "bfloat16", "--requests", "3",
          "--route", "pallas", "--sdc", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "alexnet (bfloat16): completed 3/3" in out
    assert "balanced=yes" in out and "detections=0" in out
