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
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

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


@pytest.mark.parametrize("x_shape,w_shape,kw", [
    ((8, 13, 13, 384), (3, 3, 192, 256), dict(groups=2, pool=(3, 2))),
    ((2, 13, 13, 48), (3, 3, 24, 32), dict(groups=2, pool=(3, 2))),
    ((2, 10, 10, 12), (3, 3, 12, 8), dict(lrn=True)),
    ((2, 17, 17, 24), (3, 3, 12, 16), dict(groups=2, lrn=True, pool=(3, 2))),
    ((2, 8, 8, 5), (3, 3, 5, 40), dict(pool=(2, 2))),
])
def test_fused_winograd_blocks_start_on_the_tile_grid(x_shape, w_shape, kw):
    """Every Winograd tile of a fused layer (LRN and/or pool) starts on the
    m-grid the plain version (and the JAX kernel) uses, and the tiles
    cover each conv pixel once: a BFP-quantized Winograd slab gives each
    pixel of a tile its own effective filter, so the tiling is part of the
    function.  The CUDA kernels transform every tile of the grid once and
    pool from the whole conv map."""
    kw = dict(kw)
    lrn = t_pool.LrnParams(*LRN) if kw.pop("lrn", False) else None
    p = t_winograd.plan(x_shape, w_shape, lrn=lrn, **kw)
    assert p.fused
    B = x_shape[0]
    hits = np.zeros((B, p.out_h + p.m, p.out_w + p.m), np.int32)
    for t in range(t_winograd.num_tiles(p, B)):
        b, oy, ox = t_winograd.tile_origin(p, t)
        assert oy % p.m == 0 and ox % p.m == 0
        assert oy < p.out_h and ox < p.out_w
        hits[b, oy:oy + p.m, ox:ox + p.m] += 1
    assert (hits[:, :p.out_h, :p.out_w] == 1).all()


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
    # conv_bfp is ported: the slab packs BFP-quantized and is marked so
    slab = t_conv.pack_conv_weights(spec, tuple(x.shape), w, bfp_pack=True)
    assert slab.bfp and slab.kernel == "cuda-winograd"
    assert not torch.equal(
        slab.data, t_conv.pack_conv_weights(spec, tuple(x.shape), w).data)


@pytest.mark.parametrize("where", ["dispatch", "plan"])
def test_row_parallel_is_refused(where):
    """Once refused, ``row_parallel=True`` is now the default launch (CUDA
    blocks are already independent over rows): through a dispatch kwarg,
    or a plan whose slab is packed for it, the output is the default
    plan's bit for bit."""
    x, w, b = _t(*_layer_inputs(dict(kernel=3), 9, 6, 8))
    spec = t_conv.ConvSpec(kernel=3, route="pallas")
    y0 = t_conv.dispatch_conv(spec, x, w, b)
    if where == "dispatch":
        y = t_conv.dispatch_conv(spec, x, w, b, row_parallel=True)
    else:
        plan = t_conv.ConvPlan(row_parallel=True)
        wp = t_conv.pack_conv_weights(spec, tuple(x.shape), w, plan=plan)
        assert torch.equal(
            wp.data, t_conv.pack_conv_weights(spec, tuple(x.shape), w).data)
        y = t_conv.dispatch_conv(spec, x, w, b, w_packed=wp, plan=plan)
    assert torch.equal(y.view(torch.int32), y0.view(torch.int32))


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


# the direct kernel's launch geometry at full conv1 / conv2 (batch 8) and
# at every direct-kernel geometry of tests/test_torch_cuda.py:
# (name, plan kwargs, r, B, H, c_in, c_out, lrn)
DIRECT_GEOMETRIES = [
    ("conv1_full", dict(stride=4, padding="VALID", pool=(3, 2)),
     11, 8, 227, 3, 96, True),
    ("conv2_full", dict(groups=2, pool=(3, 2)), 5, 8, 27, 96, 256, True),
    ("conv1_reduced", dict(stride=4, padding="VALID", pool=(3, 2)),
     11, 2, 35, 3, 16, True),
    ("conv2_reduced", dict(groups=2, pool=(3, 2)), 5, 2, 13, 16, 32, True),
    ("s2_same_plain", dict(stride=2), 3, 2, 9, 5, 7, False),
    ("cblocks_pool2", dict(pool=(2, 2), c_block=2), 1, 2, 8, 5, 40, False),
    ("kblocks_lrn_g2", dict(groups=2, k_block=4), 3, 2, 7, 6, 16, True),
    ("m_ragged_k40_c5", dict(pool=(3, 2)), 3, 3, 11, 5, 40, True),
    ("s4_valid_k96_c3", dict(stride=4, padding="VALID", pool=(3, 2)),
     11, 1, 47, 3, 96, False),
    ("same_r5_corners_c5", dict(), 5, 2, 7, 5, 12, False),
    ("g2_c4_lrn_pool", dict(groups=2, pool=(3, 2)), 5, 2, 12, 8, 24, True),
    ("big_m_c8_k64", dict(), 3, 8, 66, 8, 64, False),
    ("lrn_in_conv_k40", dict(), 3, 2, 10, 4, 40, True),
    ("big_m_k96_lrn_in_conv", dict(), 3, 8, 66, 4, 96, True),
    ("lrn_k130_epilogue", dict(), 3, 1, 8, 3, 130, True),
]


def _direct_geometry(kw, r, B, H, c_in, c_out):
    g = kw.get("groups", 1)
    return t_direct.plan((B, H, H, c_in), (r, r, c_in // g, c_out), **kw)


@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out,lrn", DIRECT_GEOMETRIES)
def test_direct_grid_covers_each_conv_output_once(name, kw, r, B, H, c_in,
                                                  c_out, lrn):
    """The conv stage's blocks, (M tile, N tile, group) of BM conv pixels
    and BN channels, cover every conv pixel and channel of each group
    exactly once."""
    p = _direct_geometry(kw, r, B, H, c_in, c_out)
    M, BM, BN = B * p.out_h * p.out_w, t_direct.BM, t_direct.tile_cols(p)
    nm, nn, g = t_direct.conv_grid(p, B)
    assert g == p.g and (nm - 1) * BM < M <= nm * BM
    hits = np.zeros((p.g, M, p.K), np.int32)
    for grp in range(g):
        for bn in range(nn):
            for bm in range(nm):
                hits[grp, bm * BM:(bm + 1) * BM, bn * BN:(bn + 1) * BN] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out,lrn", DIRECT_GEOMETRIES)
def test_direct_scratch_shape(name, kw, r, B, H, c_in, c_out, lrn):
    """The conv stage writes y (B, out_h, out_w, g*K), the conv map the
    plain version pools, when there is a pool or an LRN across more
    channels than one block tile holds; otherwise no scratch: the conv
    stage writes the output."""
    p = _direct_geometry(kw, r, B, H, c_in, c_out)
    lrn_p = t_pool.LrnParams(*LRN) if lrn else None
    pool = kw.get("pool")
    in_conv = t_direct.lrn_in_conv_stage(p, lrn_p)
    assert in_conv == (lrn and p.g == 1 and p.K <= t_direct.tile_cols(p))
    shape = t_direct.scratch_shape(p, B, lrn_p, pool)
    if pool is None and (lrn_p is None or in_conv):
        assert shape is None
        return
    assert shape == (B, p.out_h, p.out_w, c_out)
    if p.s == 1 or kw.get("padding") == "VALID":
        conv = torch.nn.functional.conv2d(
            torch.zeros(1, c_in, H, H),
            torch.zeros(c_out, c_in // p.g, r, r), stride=p.s, groups=p.g,
            padding="same" if p.s == 1 and kw.get("padding") != "VALID"
            else 0)
        assert shape[1:3] == tuple(conv.shape[2:])
    # the scratch for full conv1 / conv2 is 9.3 / 6.0 MB: L2-resident
    if name in ("conv1_full", "conv2_full"):
        assert np.prod(shape) * 4 < 10e6


@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out,lrn", DIRECT_GEOMETRIES)
def test_direct_shared_memory_fits_a_block(name, kw, r, B, H, c_in, c_out,
                                           lrn):
    """Each conv-stage block's shared memory (the A and B rings and the tap
    tables) fits the 227 KB an H100 block may have; an epilogue block
    stays near its output target."""
    p = _direct_geometry(kw, r, B, H, c_in, c_out)
    BN = t_direct.tile_cols(p)
    assert BN in (64, 96)
    smem = t_direct.smem_bytes(p)
    assert smem == (t_direct.STAGES * (t_direct.BM * (t_direct.BK + 4)
                                       + t_direct.BK * BN)
                    + 2 * p.r * p.r * p.C) * 4
    assert smem <= 227 * 1024
    PT = t_direct.block_tile(p.Kfull)
    assert PT >= 1 and (PT * PT * p.Kfull <= t_direct.EPILOGUE_OUTPUTS
                        or PT == 1)


@pytest.mark.parametrize("name,BN,blocks", [("conv1_full", 96, 379),
                                            ("conv2_full", 64, 368)])
def test_direct_grid_fills_the_card(name, BN, blocks):
    """Full conv1 and conv2 launch 180-380 conv-stage blocks, at least
    one block on each of the H100's 132 SMs and at most one wave of three
    an SM, with no padded channels (K = 96 and 128 a group)."""
    geo = next(g for g in DIRECT_GEOMETRIES if g[0] == name)
    p = _direct_geometry(*geo[1:7])
    assert t_direct.tile_cols(p) == BN and p.K % BN == 0
    nm, nn, g = t_direct.conv_grid(p, geo[3])
    assert nm * nn * g == blocks and 132 <= blocks <= 3 * 132


# the Winograd kernels' launch geometry at full conv3-conv5 (batch 8) and
# at every Winograd geometry of tests/test_torch_cuda.py:
# (name, plan kwargs, B, H, c_in, c_out, lrn)
WINO_GEOMETRIES = [
    ("conv3_full", dict(), 8, 13, 256, 384, False),
    ("conv4_full", dict(groups=2), 8, 13, 384, 384, False),
    ("conv5_full", dict(groups=2, pool=(3, 2)), 8, 13, 384, 256, False),
    ("conv3_reduced", dict(), 2, 13, 32, 48, False),
    ("conv4_reduced", dict(groups=2), 2, 13, 48, 48, False),
    ("conv5_reduced", dict(groups=2, pool=(3, 2)), 2, 13, 48, 32, False),
    ("valid_kpad", dict(padding="VALID", k_block=32), 2, 11, 8, 40, False),
    ("lrn_only_cblocks", dict(c_block=4), 2, 10, 12, 8, True),
    ("lrn_pool_kblocks_g2", dict(groups=2, pool=(3, 2), k_block=4),
     2, 17, 24, 16, True),
    ("ragged_c5_k40_pool", dict(pool=(3, 2)), 3, 11, 5, 40, False),
    ("ragged_k130", dict(), 1, 9, 5, 130, False),
    ("valid11_c5_k130_lrn", dict(padding="VALID"), 2, 11, 5, 130, True),
    ("kb_not_x4_g2", dict(groups=2), 2, 9, 6, 20, False),
]


def _wino_geometry(kw, B, H, c_in, c_out, lrn):
    g = kw.get("groups", 1)
    lrn_p = t_pool.LrnParams(*LRN) if lrn else None
    p = t_winograd.plan((B, H, H, c_in), (3, 3, c_in // g, c_out),
                        lrn=lrn_p, **kw)
    return p, lrn_p


@pytest.mark.parametrize("name,kw,B,H,c_in,c_out,lrn", WINO_GEOMETRIES)
def test_winograd_gemm_grid_covers_each_product_once(name, kw, B, H, c_in,
                                                     c_out, lrn):
    """The batched GEMM's blocks, (T tile, K tile, position x group) of BM
    Winograd tiles and BN output channels, cover every (position, group,
    tile, output channel) exactly once, and its T rows are the tiles of
    the 4-grid over every image."""
    p, _ = _wino_geometry(kw, B, H, c_in, c_out, lrn)
    T, BM, BN = t_winograd.num_tiles(p, B), t_winograd.BM, t_winograd.BN
    assert T == B * -(-p.out_h // 4) * -(-p.out_w // 4)
    nt, nn, npg = t_winograd.gemm_grid(p, B)
    assert npg == 36 * p.g and (nt - 1) * BM < T <= nt * BM
    hits = np.zeros((npg, T, p.K), np.int32)
    for z in range(npg):
        for bn in range(nn):
            for bt in range(nt):
                hits[z, bt * BM:(bt + 1) * BM, bn * BN:(bn + 1) * BN] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("name,kw,B,H,c_in,c_out,lrn", WINO_GEOMETRIES)
def test_winograd_scratch_shapes(name, kw, B, H, c_in, c_out, lrn):
    """U (36, g, T, Cu) with C padded to the GEMM's chunk, M (36, g, T,
    K), and the conv map (B, out_h, out_w, g*K) only when an LRN or a pool
    follows; at full conv3-conv5 each fits the 50 MB L2 with room (under
    10 MB)."""
    p, lrn_p = _wino_geometry(kw, B, H, c_in, c_out, lrn)
    T = t_winograd.num_tiles(p, B)
    cu = t_winograd.u_channels(p)
    assert cu % t_winograd.BK == 0 and p.C <= cu < p.C + t_winograd.BK
    shapes = t_winograd.scratch_shapes(p, B, lrn_p, kw.get("pool"))
    assert shapes["u"] == (36, p.g, T, cu)
    assert shapes["m"] == (36, p.g, T, c_out // p.g)
    if kw.get("pool") is None and not lrn:
        assert shapes["conv"] is None
    else:
        assert shapes["conv"] == (B, p.out_h, p.out_w, c_out)
    if name.endswith("_full"):
        for shape in shapes.values():
            assert shape is None or np.prod(shape) * 4 < 10e6


@pytest.mark.parametrize("name,kw,B,H,c_in,c_out,lrn", WINO_GEOMETRIES)
def test_winograd_shared_memory_fits_a_block(name, kw, B, H, c_in, c_out,
                                             lrn):
    """A GEMM block's shared memory (the A and B rings and the channel
    table) fits the 48 KB a launch gets without opting in (of the 227 KB
    an H100 block may have)."""
    p, _ = _wino_geometry(kw, B, H, c_in, c_out, lrn)
    smem = t_winograd.smem_bytes(p)
    assert smem == (t_winograd.STAGES * (
        t_winograd.BM * (t_winograd.BK + 4)
        + t_winograd.BK * t_winograd.BN) + t_winograd.u_channels(p)) * 4
    assert smem <= 48 * 1024 <= 227 * 1024


@pytest.mark.parametrize("name,blocks", [("conv3_full", 432),
                                         ("conv4_full", 432),
                                         ("conv5_full", 288)])
def test_winograd_grid_fills_the_card(name, blocks):
    """Full conv3, conv4 and conv5 launch 288-432 GEMM blocks: at least one
    on each of the H100's 132 SMs and at most one wave of four an SM."""
    geo = next(g for g in WINO_GEOMETRIES if g[0] == name)
    p, _ = _wino_geometry(*geo[1:])
    nt, nn, npg = t_winograd.gemm_grid(p, geo[2])
    assert nt * nn * npg == blocks and 132 <= blocks <= 4 * 132


