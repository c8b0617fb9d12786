"""Conv layers of the PyTorch port against the JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
The JAX side runs its Pallas kernels in interpret mode (as its own tests
do); the port's wrappers take their kernels' plain PyTorch versions on a
CPU tensor, so these tests exercise the port's plans, slab packing and
slab indexing.  Tolerances: rtol = atol = 1e-4 for layer outputs (both
float32, summed in different orders, Winograd transforms included); the
direct slab is a pure re-layout and must match exactly; the Winograd slab
(G w G^T, an f32 product) to atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import winograd as j_wg  # noqa: E402
from repro.kernels.conv import ops as j_ops  # noqa: E402
from repro.nn import conv as j_conv  # noqa: E402
from repro.nn import pooling as j_pool  # noqa: E402
from repro_torch.core import winograd as t_wg  # noqa: E402
from repro_torch.kernels.conv import direct as t_direct  # noqa: E402
from repro_torch.kernels.conv import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv import winograd as t_winograd  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.nn import pooling as t_pool  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# the five reduced AlexNet layer geometries of tests/test_fused_pipeline.py
ALEXNET_LAYERS = [
    ("conv1", dict(kernel=11, stride=4, padding="VALID", relu=True,
                   fuse_lrn=True, fuse_pool=True), 35, 3, 16),
    ("conv2", dict(kernel=5, groups=2, relu=True, fuse_lrn=True,
                   fuse_pool=True), 13, 16, 32),
    ("conv3", dict(kernel=3, relu=True), 13, 32, 48),
    ("conv4", dict(kernel=3, groups=2, relu=True), 13, 48, 48),
    ("conv5", dict(kernel=3, groups=2, relu=True, fuse_pool=True),
     13, 48, 32),
]

# full-width AlexNet layers at batch 8: (name, spec kwargs, H, c_in, c_out)
FULL_LAYERS = [
    ("conv1", ALEXNET_LAYERS[0][1], 227, 3, 96),
    ("conv2", ALEXNET_LAYERS[1][1], 27, 96, 256),
    ("conv3", ALEXNET_LAYERS[2][1], 13, 256, 384),
    ("conv4", ALEXNET_LAYERS[3][1], 13, 384, 384),
    ("conv5", ALEXNET_LAYERS[4][1], 13, 384, 256),
]


def _layer_inputs(kw, H, c_in, c_out, seed=0, B=2):
    rng = np.random.default_rng(seed)
    k, g = kw["kernel"], kw.get("groups", 1)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((k, k, c_in // g, c_out)) * 0.3
         ).astype(np.float32)
    b = rng.standard_normal((c_out,)).astype(np.float32)
    return x, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("route", ["direct", "winograd", "pallas"])
@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS)
def test_dispatch_conv_matches_jax(route, name, kw, H, c_in, c_out):
    """One AlexNet layer through both packages' dispatch_conv, per route
    (``pallas``: the JAX kernels in interpret mode vs the port's kernel
    wrappers, which take the plain versions on the CPU)."""
    x, w, b = _layer_inputs(kw, H, c_in, c_out)
    ref = np.asarray(j_conv.dispatch_conv(
        j_conv.ConvSpec(route=route, **kw), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b), interpret=True))
    got = t_conv.dispatch_conv(t_conv.ConvSpec(route=route, **kw),
                               *_t(x, w, b)).numpy()
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, err_msg=f"{name} via {route}",
                               **TOL)


@pytest.mark.parametrize("name,kw,H,c_in,c_out",
                         ALEXNET_LAYERS + [(f"{n}_full", *rest) for n, *rest
                                           in FULL_LAYERS])
def test_packed_slabs_match_jax(name, kw, H, c_in, c_out):
    """The slab a kernel reads: same resolved kernel, shape and values as
    the JAX package's, at the reduced and the full-width geometries."""
    B = 8 if name.endswith("_full") else 2
    x, w, _ = _layer_inputs(kw, 1, c_in, c_out, B=1)
    shape = (B, H, H, c_in)
    ref = j_conv.pack_conv_weights(j_conv.ConvSpec(route="pallas", **kw),
                                   shape, jnp.asarray(w))
    got = t_conv.pack_conv_weights(t_conv.ConvSpec(route="pallas", **kw),
                                   shape, torch.from_numpy(w))
    assert got.kernel == ref.kernel.replace("pallas-", "cuda-")
    want, have = np.asarray(ref.data), got.data.numpy()
    assert have.shape == want.shape
    if got.kernel == "cuda-direct":
        assert np.array_equal(have, want)
    else:
        np.testing.assert_allclose(have, want, rtol=0, atol=1e-6)


def test_conv4_slab_pads_k_to_the_block():
    """conv4's 192 output channels a group pad to Kp = 256 on the unfused
    Winograd plan; the pad columns are zeros the kernel never reads."""
    p = t_winograd.plan((8, 13, 13, 384), (3, 3, 192, 384), groups=2)
    assert (p.K, p.Kb, p.Kp, p.nkb, p.fused) == (192, 128, 256, 2, False)
    w = torch.from_numpy(_layer_inputs(FULL_LAYERS[3][1], 1, 384, 384,
                                       B=1)[1])
    slab = t_winograd.pack_weights(w, p)
    assert tuple(slab.shape) == (4, 6, 6, 192, 128)
    # tile lin = k * ncb + c: K blocks 1 and 3 hold channels 128..255 of
    # each group, of which 192..255 are pad
    assert torch.count_nonzero(slab[1][..., 64:]) == 0
    assert torch.count_nonzero(slab[3][..., 64:]) == 0
    assert torch.count_nonzero(slab[1][..., :64]) > 0


LRN = (5, 2.0, 1e-4, 0.75)

# off-AlexNet blockings the kernels must also index right: several channel
# blocks with channel padding, several K blocks, strides, VALID / SAME,
# LRN without pool, pool without LRN
DIRECT_CASES = [
    ("s2_same_plain", dict(stride=2), 3, 9, 5, 7),
    ("cblocks_pool2", dict(pool=(2, 2), c_block=2), 1, 8, 5, 40),
    ("kblocks_lrn_g2", dict(groups=2, lrn=True, k_block=4), 3, 7, 6, 16),
    ("s3_valid_lrn_pool", dict(stride=3, padding="VALID", lrn=True,
                               pool=(3, 2)), 5, 23, 4, 8),
]
WINO_CASES = [
    ("valid_kpad", dict(padding="VALID", k_block=32), 11, 8, 40),
    ("lrn_only_cblocks", dict(lrn=True, c_block=4), 10, 12, 8),
    ("lrn_pool_kblocks_g2", dict(groups=2, lrn=True, pool=(3, 2),
                                 k_block=4), 17, 24, 16),
    ("pool2_cblocks_g2", dict(groups=2, pool=(2, 2), c_block=8), 12, 20, 12),
]


def _fusion(kw, lrn_cls):
    kw = dict(kw)
    if kw.pop("lrn", False):
        kw["lrn"] = lrn_cls(*LRN)
    return kw


@pytest.mark.parametrize("name,kw,r,H,c_in,c_out", DIRECT_CASES)
def test_direct_kernel_plain_matches_jax_kernel(name, kw, r, H, c_in, c_out):
    x, w, b = _layer_inputs(dict(kernel=r, groups=kw.get("groups", 1)),
                            H, c_in, c_out, seed=7)
    ref = np.asarray(j_ops.conv2d_direct(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True,
        interpret=True, **_fusion(kw, j_pool.LrnParams)))
    n0 = t_direct.launches
    got = t_ops.conv2d_direct(*_t(x, w, b), relu=True,
                              **_fusion(kw, t_pool.LrnParams)).numpy()
    assert t_direct.launches == n0          # the plain version never counts
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name,kw,H,c_in,c_out", WINO_CASES)
def test_winograd_kernel_plain_matches_jax_kernel(name, kw, H, c_in, c_out):
    x, w, b = _layer_inputs(dict(kernel=3, groups=kw.get("groups", 1)),
                            H, c_in, c_out, seed=8)
    ref = np.asarray(j_ops.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True,
        interpret=True, **_fusion(kw, j_pool.LrnParams)))
    before = t_ops.launch_counts()
    got = t_ops.conv2d(*_t(x, w, b), relu=True,
                       **_fusion(kw, t_pool.LrnParams)).numpy()
    assert t_ops.launch_counts() == before
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_versions_read_only_the_slab():
    """The plain versions compute from the packed slab alone: a slab from
    other filters changes the output, the raw filters do not."""
    x, w, b = _layer_inputs(dict(kernel=3), 9, 6, 8, seed=9)
    x, w, b = _t(x, w, b)
    p = t_winograd.plan(tuple(x.shape), tuple(w.shape))
    slab = t_winograd.pack_weights(w, p)
    y = t_winograd.conv2d_winograd_plain(x, slab, b, p, relu=False,
                                         lrn=None, pool=None)
    y_other = t_winograd.conv2d_winograd(x, torch.zeros_like(w), b, slab)
    assert torch.equal(y, y_other)
    y_bad = t_winograd.conv2d_winograd_plain(x, slab * 2, b, p, relu=False,
                                             lrn=None, pool=None)
    assert not torch.allclose(y, y_bad)


def test_stale_slab_is_refused():
    x, w, b = _t(*_layer_inputs(dict(kernel=3), 9, 6, 8))
    p = t_winograd.plan((2, 9, 9, 6), (3, 3, 6, 8))
    slab = t_winograd.pack_weights(w, p)
    with pytest.raises(ValueError, match="does not match"):
        t_winograd.conv2d_winograd(x, w, b, slab[:, :, :, :3])


@pytest.mark.parametrize("m", [2, 4, 6])
def test_winograd_transform_is_the_jax_packages(m):
    t, j = t_wg.winograd_transform(m, 3), j_wg.winograd_transform(m, 3)
    for name in ("AT", "G", "BT"):
        assert np.array_equal(getattr(t, name), getattr(j, name)), name


@pytest.mark.parametrize("H,c,pw,ps", [(13, 10, 3, 2), (8, 7, 2, 2),
                                       (12, 16, 3, 2)])
def test_lrn_and_maxpool_match_jax(H, c, pw, ps):
    x = np.random.default_rng(H).standard_normal((2, H, H, c)).astype(
        np.float32)
    ref = np.asarray(j_pool.apply_epilogue(
        jnp.asarray(x), j_pool.LrnParams(*LRN), (pw, ps)))
    got = t_pool.apply_epilogue(torch.from_numpy(x), t_pool.LrnParams(*LRN),
                                (pw, ps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert t_pool.pooled_hw(H, pw, ps) == j_pool.pooled_hw(H, pw, ps)


@pytest.mark.parametrize("args", [
    dict(hp=15, wp=15, c=256, batch=8), dict(hp=231, wp=231, c=3, batch=8),
    dict(hp=500, wp=500, c=512, batch=8)])
def test_auto_blocks_match_jax(args):
    hp, wp, c, batch = args["hp"], args["wp"], args["c"], args["batch"]
    assert (t_wg.auto_c_block(hp, wp, c, batch=batch)
            == j_wg.auto_c_block(hp, wp, c, batch=batch))
    kw = dict(cols=wp, kfull=c, batch=batch)
    assert (t_wg.auto_pool_rows(hp // 2, 3, 2, **kw)
            == j_wg.auto_pool_rows(hp // 2, 3, 2, **kw))


def test_resolve_kernel_names():
    """Route ``pallas`` keeps the JAX package's name; the kernels it
    resolves to are reported as ``cuda-direct`` / ``cuda-winograd``."""
    for _, kw, H, _, _ in ALEXNET_LAYERS:
        for route in t_conv.ROUTES:
            t = t_conv.resolve_kernel(t_conv.ConvSpec(route=route, **kw),
                                      in_hw=H)
            j = j_conv.resolve_kernel(j_conv.ConvSpec(route=route, **kw),
                                      in_hw=H)
            assert t == j.replace("pallas-", "cuda-")
    tiny = t_conv.ConvSpec(kernel=3, route="pallas", fuse_pool=True)
    assert t_conv.resolve_kernel(tiny, in_hw=2) == "direct"


def test_unported_options_raise():
    x, w, b = _t(*_layer_inputs(dict(kernel=3), 9, 6, 8))
    spec = t_conv.ConvSpec(kernel=3, route="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_conv.dispatch_conv(spec, x, w, b, abft=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_conv.pack_conv_weights(spec, tuple(x.shape), w, bfp_pack=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_conv.pack_conv_weights(spec, tuple(x.shape), w, fingerprint=True)


@pytest.mark.parametrize("where", ["dispatch", "plan"])
def test_row_parallel_is_refused(where):
    """The TPU's row-parallel regime has no CUDA counterpart yet: asking
    for it raises instead of running the default kernel under its name."""
    x, w, b = _t(*_layer_inputs(dict(kernel=3), 9, 6, 8))
    spec = t_conv.ConvSpec(kernel=3, route="pallas")
    with pytest.raises(NotImplementedError, match="row_parallel.*ROADMAP"):
        if where == "dispatch":
            t_conv.dispatch_conv(spec, x, w, b, row_parallel=True)
        else:
            t_conv.pack_conv_weights(spec, tuple(x.shape), w,
                                     plan=t_conv.ConvPlan(row_parallel=True))


def test_cuda_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device it has no kernel for is refused, never computed another way."""
    x, w, b = (t.to("meta") for t in _t(*_layer_inputs(dict(kernel=3), 9,
                                                       6, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        t_winograd.conv2d_winograd(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        t_direct.conv2d_direct(x, w, b)


def test_pack_context_is_the_jax_format():
    for _, kw, _, _, _ in ALEXNET_LAYERS:
        t_spec = t_conv.ConvSpec(route="pallas", **kw)
        j_spec = j_conv.ConvSpec(route="pallas", **kw)
        t_knobs = t_conv.plan_knobs(k_block=64, batch_block=4)
        j_knobs = j_conv.plan_knobs(k_block=64, batch_block=4)
        got = t_conv.pack_context(t_spec, "cuda-direct", bfp_pack=False,
                                  abft=False, knobs=t_knobs)
        want = j_conv.pack_context(j_spec, "cuda-direct", bfp_pack=False,
                                   abft=False, knobs=j_knobs)
        assert got == want


@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS)
def test_plan_knobs_reblock_the_slab_not_the_result(name, kw, H, c_in,
                                                     c_out):
    """A non-default ConvPlan re-blocks the slab (several channel and K
    blocks) and leaves the layer's output unchanged; a plan's route
    overrides the spec's."""
    x, w, b = _t(*_layer_inputs(kw, H, c_in, c_out, seed=11))
    spec = t_conv.ConvSpec(route="pallas", **kw)
    base = t_conv.dispatch_conv(spec, x, w, b)
    plan = t_conv.ConvPlan(c_block=4, k_block=8, batch_block=1)
    slab = t_conv.pack_conv_weights(spec, tuple(x.shape), w, plan=plan)
    assert slab.data.shape[0] > t_conv.pack_conv_weights(
        spec, tuple(x.shape), w).data.shape[0]
    got = t_conv.dispatch_conv(spec, x, w, b, plan=plan, w_packed=slab)
    torch.testing.assert_close(got, base, rtol=1e-5, atol=1e-5)
    direct = t_conv.dispatch_conv(spec, x, w, b,
                                  plan=t_conv.ConvPlan(route="direct"))
    torch.testing.assert_close(direct, base, **TOL)
