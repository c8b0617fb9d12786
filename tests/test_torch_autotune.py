"""The port's measured autotuner against the JAX package's, on the CPU.

The reference's plan plumbing (``ConvPlan``, ``plan_knobs``, ``plan_key``,
``PlanCache``) must mean the same in both packages, field for field, but
for the backend a plan was measured on.  The port's candidates are the
CUDA kernels' block tiles: on a CPU tensor every wrapper runs its plain
version, so the tests hold the plumbing (enumeration, dedupe, tile checks,
cache round trips, the engine's hook) and the outputs: every candidate
bit-equal to the default plan, and within rtol = atol = 1e-4 of the JAX
package's ``dispatch_conv(..., interpret=True)`` (both float32, summed in
other orders).  Inputs are made with numpy from a seed, at the five
reduced AlexNet geometries of ``tests/test_autotune.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.core import autotune as j_at  # noqa: E402
from repro.nn import conv as j_conv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core import timing  # noqa: E402
from repro_torch.kernels.conv import direct, winograd  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.serving import CnnEngine, CnnServeConfig, \
    ImageRequest  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# the five reduced AlexNet layer geometries of tests/test_autotune.py
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

# full-width AlexNet at batch 8: (name, spec kwargs, H, c_in, c_out)
FULL_LAYERS = [
    ("conv1", ALEXNET_LAYERS[0][1], 227, 3, 96),
    ("conv2", ALEXNET_LAYERS[1][1], 27, 96, 256),
    ("conv3", ALEXNET_LAYERS[2][1], 13, 256, 384),
    ("conv4", ALEXNET_LAYERS[3][1], 13, 384, 384),
    ("conv5", ALEXNET_LAYERS[4][1], 13, 384, 256),
]

SMEM_LIMIT = 227 * 1024     # an H100 block's dynamic shared memory


def _arrays(kw, H, c_in, c_out, seed=0, B=3):
    rng = np.random.default_rng(seed)
    k = kw["kernel"]
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((k, k, c_in // kw.get("groups", 1), c_out))
         * k ** -1).astype(np.float32)
    b = rng.standard_normal((c_out,)).astype(np.float32)
    return x, w, b


def _bits(y):
    return y.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# plan, knobs and keys against the reference
# ---------------------------------------------------------------------------
def test_convplan_dict_roundtrip_and_reference_plans_load():
    p = t_conv.ConvPlan(batch_block=2, k_block=64, pool_row_block=2,
                        weight_prefetch=False, row_parallel=True,
                        tile_rows=128, tile_cols=96)
    assert t_conv.ConvPlan.from_dict(p.to_dict()) == p
    assert t_conv.ConvPlan.from_dict({**p.to_dict(), "future_knob": 1}) == p
    assert t_conv.ConvPlan() == t_conv.DEFAULT_PLAN
    # a plan the reference wrote loads with its fields and the default tile
    ref = j_conv.ConvPlan(batch_block=2, k_block=64, c_block=16,
                          pool_row_block=2, weight_prefetch=False,
                          row_parallel=True, route="pallas")
    got = t_conv.ConvPlan.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert {k: v for k, v in got.to_dict().items()
            if k not in ("tile_rows", "tile_cols")} == ref.to_dict()
    assert got.tile_rows is None and got.tile_cols is None


@pytest.mark.parametrize("case", ["plan", "kwarg", "none_overrides",
                                  "no_plan"])
def test_plan_knobs_precedence_equals_the_reference(case):
    """Explicit kwarg beats plan beats default, in both packages alike."""
    plans = {"plan": (dict(batch_block=2, k_block=64,
                           weight_prefetch=False), {}),
             "kwarg": (dict(batch_block=2, k_block=64,
                            weight_prefetch=False), dict(batch_block=4)),
             "none_overrides": (dict(pool_row_block=2),
                                dict(pool_row_block=None)),
             "no_plan": (None, {})}
    plan_kw, kw = plans[case]
    j = j_conv.plan_knobs(None if plan_kw is None
                          else j_conv.ConvPlan(**plan_kw), **kw)
    t = t_conv.plan_knobs(None if plan_kw is None
                          else t_conv.ConvPlan(**plan_kw), **kw)
    got = t.to_dict()
    assert got.pop("tile_rows") is None and got.pop("tile_cols") is None
    assert got == j.to_dict()


def test_plan_knobs_keep_the_plans_tile():
    base = t_conv.ConvPlan(tile_rows=128, tile_cols=64)
    k = t_conv.plan_knobs(base, batch_block=4)
    assert (k.tile_rows, k.tile_cols, k.batch_block) == (128, 64, 4)


@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS)
def test_plan_key_equals_the_reference_but_backend(name, kw, H, c_in, c_out):
    shape = (2, H, H, c_in)
    j = j_at.plan_key(j_conv.ConvSpec(route="pallas", **kw), shape,
                      interpret=True)
    t = at.plan_key(t_conv.ConvSpec(route="pallas", **kw), shape,
                    device="cpu")
    assert j.pop("backend") == "cpu-interpret"
    assert t.pop("backend") == "cpu"
    assert t == j
    assert list(t) == list(j)


def test_plan_key_discriminates_and_is_stable():
    spec = t_conv.ConvSpec(kernel=3, relu=True, route="pallas")
    k1 = at.plan_key(spec, (2, 13, 13, 32), device="cpu")
    assert at.key_str(k1) == at.key_str(dict(reversed(list(k1.items()))))
    others = [at.plan_key(spec, (4, 13, 13, 32), device="cpu"),
              at.plan_key(dataclasses.replace(spec, fuse_pool=True),
                          (2, 13, 13, 32), device="cpu"),
              at.plan_key(spec, (2, 13, 13, 32), dtype=torch.bfloat16,
                          device="cpu"),
              dict(k1, backend="cuda-sm90-NVIDIA H100 80GB HBM3")]
    assert len({at.key_str(k) for k in [k1] + others}) == 5
    assert others[2]["dtype"] == "bfloat16"
    assert at.backend_kind("cpu") == "cpu"


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------
def _key():
    return at.plan_key(t_conv.ConvSpec(kernel=3, relu=True, route="pallas"),
                       (2, 13, 13, 32), device="cpu")


def test_plan_cache_roundtrip_and_any_batch(tmp_path):
    key = _key()
    plan = t_conv.ConvPlan(tile_rows=32, tile_cols=64)
    cache = at.PlanCache()
    cache.put(key, plan, {"default_us": 10.0, "tuned_us": 7.0})
    path = cache.save(tmp_path / "sub" / "plans.json")
    assert not (tmp_path / "sub" / "plans.json.tmp").exists()
    loaded = at.PlanCache.load(path)
    assert loaded.get(key) == plan
    assert loaded.stats(key)["tuned_us"] == 7.0
    other = dict(key, batch=16)
    assert loaded.get(other) is None
    assert loaded.get(other, any_batch=True) == plan
    assert loaded.get(dict(key, h=27, w=27), any_batch=True) is None
    assert loaded.get(dict(key, backend="cpu-interpret"),
                      any_batch=True) is None
    data = json.loads((tmp_path / "sub" / "plans.json").read_text())
    assert data["version"] == 1 and len(data["entries"]) == 1
    # the reference reads the port's file format
    assert j_at.PlanCache.load(path).entries == loaded.entries


@pytest.mark.parametrize("name,text", [
    ("garbage", "{not json at all"),
    ("truncated", '{"version": 1, "entries": {"k": {"plan": {"batch_bl'),
    ("wrong_version", json.dumps({"version": 99, "entries": {}})),
    ("no_version", json.dumps({"entries": {}})),
    ("alien_schema", json.dumps({"version": 1, "entries": "nope"})),
    ("bad_entry", json.dumps({"version": 1, "entries": {"k": {"no_plan": 1}}})),
    ("plan_not_a_dict", json.dumps(
        {"version": 1, "entries": {"k": {"plan": 3, "key": {}}}})),
])
def test_plan_cache_load_broken_falls_back(tmp_path, name, text):
    """A broken cache never takes down an engine: it warns and loads
    empty (every plan is bit-equal to the default anyway)."""
    p = tmp_path / f"{name}.json"
    p.write_text(text)
    with pytest.warns(UserWarning, match="plan cache"):
        cache = at.PlanCache.load(p)
    assert not cache.entries and cache.get(_key()) is None


def test_plan_cache_missing_file_is_silent(tmp_path):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cache = at.PlanCache.load(tmp_path / "nope.json")
        assert at.load_alexnet_plans(get_config("alexnet"), 8,
                                     path=tmp_path / "nope.json",
                                     device="cpu") == {}
    assert not cache.entries


def test_reference_cache_yields_no_plans():
    """The reference's committed cache is keyed ``cpu-interpret``: even at
    the geometry it was tuned at, it steers no port kernel."""
    ref = at.PLAN_DIR / "alexnet.json"
    entries = json.loads(ref.read_text())["entries"]
    assert entries and all(e["key"]["backend"] == "cpu-interpret"
                           for e in entries.values())
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              image_size=131, use_pallas=True)
    for c in (cfg, get_config("alexnet"),
              dataclasses.replace(get_config("alexnet"), use_pallas=True)):
        for batch in (2, 4, 8):
            assert at.load_alexnet_plans(c, batch, path=ref,
                                         device="cpu") == {}
    # the same geometry keyed to the reference's backend would hit
    key = entries[next(iter(entries))]["key"]
    assert at.PlanCache.load(ref).get(key) is not None


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS)
def test_enumeration_default_first_deduped_by_launch(name, kw, H, c_in,
                                                     c_out):
    spec = t_conv.ConvSpec(route="pallas", **kw)
    x, w, _ = _arrays(kw, H, c_in, c_out)
    plans = at.enumerate_plans(spec, x.shape, w.shape)
    assert plans[0] == t_conv.DEFAULT_PLAN
    assert len(plans) == len(set(plans))
    kernel = t_conv.resolve_kernel(spec, in_hw=H)
    sigs = [at._effective_signature(spec, kernel, x.shape, w.shape, p)
            for p in plans]
    assert len(set(sigs)) == len(sigs)
    # one candidate a tile the kernel is built for on this slab; the
    # stream knobs, which launch the same kernels, never add a candidate
    assert sorted(s[2] for s in sigs) == sorted(at.kernel_tiles(kernel))
    assert all(p.c_block is None and p.k_block == 128
               and p.batch_block == 8 for p in plans)
    assert len(at.enumerate_plans(spec, x.shape, w.shape,
                                  max_candidates=2)) == 2


def test_enumeration_off_the_kernels_is_default_only():
    for route in ("direct", "winograd", "auto"):
        spec = t_conv.ConvSpec(kernel=3, relu=True, route=route)
        assert at.enumerate_plans(spec, (2, 13, 13, 8), (3, 3, 8, 8)) == [
            t_conv.DEFAULT_PLAN]
    # a pool wider than the conv output falls back to the direct route
    spec = t_conv.ConvSpec(kernel=3, fuse_pool=True, pool_window=5,
                           route="pallas")
    assert at.enumerate_plans(spec, (1, 3, 3, 8), (3, 3, 8, 8)) == [
        t_conv.DEFAULT_PLAN]


def test_enumeration_leaves_out_tiles_the_slab_cannot_take():
    """Kb = 10 (not a multiple of 4): only the tiles built for 4-byte slab
    copies are candidates."""
    spec = t_conv.ConvSpec(kernel=3, groups=2, relu=True, route="pallas")
    plans = at.enumerate_plans(spec, (2, 9, 9, 6), (3, 3, 3, 20))
    assert [at._effective_signature(spec, "cuda-winograd", (2, 9, 9, 6),
                                    (3, 3, 3, 20), p)[2]
            for p in plans] == list(winograd.ANY_SLAB_TILES)
    dspec = t_conv.ConvSpec(kernel=5, groups=2, relu=True, route="pallas")
    plans = at.enumerate_plans(dspec, (2, 9, 9, 6), (5, 5, 3, 20))
    assert len(plans) == len(direct.ANY_SLAB_TILES)


@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS[:2]
                         + FULL_LAYERS[:2])
def test_direct_candidates_follow_the_dtype(name, kw, H, c_in, c_out):
    """The autotuner's tiles by dtype: bf16 candidates for cuda-direct come
    from the tensor-core route's list (a bf16 slab takes every one of
    them), f32 ones from the FFMA route's TILES; kernels 2-3 draw from
    their one list at either dtype."""
    assert at.kernel_tiles("cuda-direct", torch.bfloat16) == direct.MMA_TILES
    assert at.kernel_tiles("cuda-direct", torch.float32) == direct.TILES
    assert at.kernel_tiles("cuda-winograd", torch.bfloat16) == \
        at.kernel_tiles("cuda-winograd") == winograd.TILES
    spec = t_conv.ConvSpec(route="pallas", **kw)
    shape = (8, H, H, c_in)
    w_shape = (kw["kernel"], kw["kernel"], c_in // kw.get("groups", 1),
               c_out)
    assert t_conv.resolve_kernel(spec, in_hw=H) == "cuda-direct"
    for dtype, tiles in ((torch.bfloat16, direct.MMA_TILES),
                         (torch.float32, direct.TILES)):
        plans = at.enumerate_plans(spec, shape, w_shape, dtype=dtype)
        got = [at._effective_signature(spec, "cuda-direct", shape, w_shape,
                                       p, dtype)[2] for p in plans]
        assert plans[0] == t_conv.DEFAULT_PLAN
        assert sorted(got) == sorted(tiles), dtype
    # Kb = 10: every tensor-core tile, only the any-slab FFMA tiles
    dspec = t_conv.ConvSpec(kernel=5, groups=2, relu=True, route="pallas")
    assert len(at.enumerate_plans(dspec, (2, 9, 9, 6), (5, 5, 3, 20),
                                  dtype=torch.bfloat16)) == len(
        direct.MMA_TILES)


def test_hill_climb_neighbors_stay_on_the_built_grid():
    nbs = at._neighbors(t_conv.DEFAULT_PLAN, (64, 96), direct.TILES)
    assert sorted((p.tile_rows, p.tile_cols) for p in nbs) == [
        (64, 64), (64, 128), (128, 96)]
    nbs = at._neighbors(t_conv.DEFAULT_PLAN, (64, 64), winograd.TILES)
    assert sorted((p.tile_rows, p.tile_cols) for p in nbs) == [
        (32, 64), (64, 32), (128, 64)]


# ---------------------------------------------------------------------------
# every candidate's output
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw,H,c_in,c_out", ALEXNET_LAYERS)
def test_every_candidate_bit_equal_and_matches_jax(name, kw, H, c_in, c_out):
    x, w, b = _arrays(kw, H, c_in, c_out, seed=H + c_in)
    spec = t_conv.ConvSpec(route="pallas", **kw)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    ref = np.asarray(j_conv.dispatch_conv(
        j_conv.ConvSpec(route="pallas", **kw), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b), interpret=True))
    y0 = t_conv.dispatch_conv(spec, xt, wt, bt)
    np.testing.assert_allclose(y0.numpy(), ref, **TOL)
    plans = at.enumerate_plans(spec, x.shape, w.shape)
    assert len(plans) > 1
    for plan in plans:
        wp = t_conv.pack_conv_weights(spec, x.shape, wt, plan=plan)
        y = t_conv.dispatch_conv(spec, xt, wt, bt, w_packed=wp, plan=plan)
        assert torch.equal(_bits(y), _bits(y0)), plan
        y_arm, v = t_conv.dispatch_conv(spec, xt, wt, bt, plan=plan,
                                        abft=True)
        assert torch.equal(_bits(y_arm), _bits(y0)) and int(v) == 0, plan


def test_row_parallel_matches_the_reference_default():
    """conv3 at 13 x 13, 32 -> 48 (the reference's failing multi-tile
    parity case): the port's row-parallel plan on a multi-tile slab is its
    default plan bit for bit, and within 1e-4 of the reference's default
    plan."""
    _, kw, H, c_in, c_out = ALEXNET_LAYERS[2]
    x, w, b = _arrays(kw, H, c_in, c_out, seed=7)
    ref = np.asarray(j_conv.dispatch_conv(
        j_conv.ConvSpec(route="pallas", **kw), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b), interpret=True))
    spec = t_conv.ConvSpec(route="pallas", **kw)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    y0 = t_conv.dispatch_conv(spec, xt, wt, bt)
    for pf in (True, False):
        plan = t_conv.ConvPlan(batch_block=2, k_block=max(c_out // 4, 1),
                               weight_prefetch=pf, row_parallel=True)
        wp = t_conv.pack_conv_weights(spec, x.shape, wt, plan=plan)
        assert wp.data.shape[0] > 1
        y = t_conv.dispatch_conv(spec, xt, wt, bt, w_packed=wp, plan=plan)
        assert torch.equal(_bits(y), _bits(y0))
        np.testing.assert_allclose(y.numpy(), ref, **TOL)


@pytest.mark.parametrize("which", ["direct_unbuilt", "direct_kb",
                                   "winograd_unbuilt", "winograd_kb",
                                   "pack"])
def test_a_tile_the_launcher_lacks_raises(which):
    """Never a fall-back to another tile: an unbuilt tile, or a 16-byte-
    copy tile on a slab whose Kb is not a multiple of 4, raises on the CPU
    as on the card, and so does packing a slab for such a plan."""
    if which.startswith("direct"):
        x, w, b = (torch.from_numpy(a) for a in _arrays(
            dict(kernel=5, groups=2), 9, 6, 20))
        tile = (32, 64) if which == "direct_unbuilt" else (64, 128)
        with pytest.raises(ValueError, match="conv_direct"):
            direct.conv2d_direct(x, w, b, groups=2, tile_rows=tile[0],
                                 tile_cols=tile[1])
        # the default tiles take any slab
        direct.conv2d_direct(x, w, b, groups=2, tile_rows=64, tile_cols=96)
    elif which.startswith("winograd"):
        x, w, b = (torch.from_numpy(a) for a in _arrays(
            dict(kernel=3, groups=2), 9, 6, 20))
        tile = (64, 128) if which == "winograd_unbuilt" else (32, 64)
        with pytest.raises(ValueError, match="conv_winograd"):
            winograd.conv2d_winograd(x, w, b, groups=2, tile_rows=tile[0],
                                     tile_cols=tile[1])
    else:
        spec = t_conv.ConvSpec(kernel=3, relu=True, route="pallas")
        with pytest.raises(ValueError, match="not built"):
            t_conv.pack_conv_weights(spec, (2, 9, 9, 8), torch.zeros(
                (3, 3, 8, 8)), plan=t_conv.ConvPlan(tile_cols=48))


# ---------------------------------------------------------------------------
# launch geometry of every tile
# ---------------------------------------------------------------------------
def _kernel_plan(kw, B, H, c_in, c_out, checksum):
    spec = t_conv.ConvSpec(route="pallas", **kw)
    kernel = t_conv.resolve_kernel(spec, in_hw=H)
    lrn, pool = t_conv._spec_fusion(spec)
    p = t_conv._kernel_weight_plan(
        spec, kernel, (B, H, H, c_in),
        (kw["kernel"], kw["kernel"], c_in // kw.get("groups", 1), c_out),
        lrn=lrn, pool=pool, knobs=t_conv.DEFAULT_PLAN, abft=checksum)
    return kernel, p, lrn


@pytest.mark.parametrize("checksum", [False, True], ids=["unarmed", "armed"])
@pytest.mark.parametrize("name,kw,H,c_in,c_out,B", [
    *(layer + (8,) for layer in FULL_LAYERS),
    *(layer + (3,) for layer in ALEXNET_LAYERS)])
def test_every_tile_grid_covers_the_gemm_within_shared_memory(
        name, kw, H, c_in, c_out, B, checksum):
    """For every built tile: the grid covers every GEMM row (conv pixels /
    Winograd tiles) and column (K) once, the last block holds at least one
    of each, the shared memory fits an H100 block and matches the
    launcher's formula, and the direct kernel's rings hold a conv tile for
    an LRN in the conv stage."""
    kernel, p, lrn = _kernel_plan(kw, B, H, c_in, c_out, checksum)
    mod = winograd if kernel == "cuda-winograd" else direct
    for tile in mod.TILES:
        rows, cols = tile
        if tile not in mod.ANY_SLAB_TILES and p.Kb % 4:
            continue
        if mod is winograd:
            M = winograd.num_tiles(p, B)
            nm, nn, npg = winograd.gemm_grid(p, B, tile)
            assert npg == p.n * p.n * p.g
            extra = winograd.u_channels(p)
        else:
            M = B * p.out_h * p.out_w
            nm, nn, g = direct.conv_grid(p, B, tile)
            assert g == p.g
            extra = 2 * p.r * p.r * p.C
            assert rows * cols <= direct.STAGES * (
                rows * (direct.BK + 4) + direct.BK * cols)
            assert direct.lrn_in_conv_stage(p, lrn, tile) == (
                lrn is not None and p.g == 1 and p.K <= cols)
        assert (nm - 1) * rows < M <= nm * rows
        assert (nn - 1) * cols < p.K <= nn * cols
        smem = mod.smem_bytes(p, tile)
        assert smem == 4 * (mod.STAGES * (rows * (mod.BK + 4)
                                          + mod.BK * cols) + extra
                            + (256 if checksum else 0))
        assert smem <= SMEM_LIMIT, (name, tile, smem)


@pytest.mark.parametrize("checksum", [False, True], ids=["unarmed", "armed"])
@pytest.mark.parametrize("name,kw,H,c_in,c_out,B", [
    *(layer + (8,) for layer in FULL_LAYERS[:2]),
    *(layer + (3,) for layer in ALEXNET_LAYERS[:2])])
def test_mma_tile_grid_covers_the_gemm_within_shared_memory(
        name, kw, H, c_in, c_out, B, checksum):
    """The bf16-slab (tensor-core) route at every tile of its list: the
    grid covers every conv pixel and channel once, the last block holds
    at least one of each, two threads a tile row, and its shared memory
    (the bf16 rings or an LRN's f32 tile, the tables, one ABFT int a
    thread) fits an H100 block; the default tile is 64 x 96 at conv1 and
    64 x 64 at conv2 (grids 379 x 1 x 1 and 92 x 2 x 2 at batch 8)."""
    kernel, p, lrn = _kernel_plan(kw, B, H, c_in, c_out, checksum)
    bf16 = torch.bfloat16
    assert kernel == "cuda-direct"
    for tile in direct.MMA_TILES:
        rows, cols = tile
        M = B * p.out_h * p.out_w
        nm, nn, g = direct.conv_grid(p, B, tile, slab_dtype=bf16)
        assert g == p.g
        assert (nm - 1) * rows < M <= nm * rows
        assert (nn - 1) * cols < p.K <= nn * cols
        assert direct.block_threads(tile, bf16) == 2 * rows
        ring = 2 * direct.MMA_STAGES * (rows * (direct.BK + 8)
                                        + direct.BK * (cols + 8))
        smem = direct.smem_bytes(p, tile, slab_dtype=bf16)
        assert smem == max(ring, 4 * rows * cols) + 4 * (
            2 * p.r * p.r * p.C + cols + (2 * rows if checksum else 0))
        assert smem <= SMEM_LIMIT, (name, tile, smem)
        assert direct.lrn_in_conv_stage(p, lrn, tile, slab_dtype=bf16) == (
            lrn is not None and p.g == 1 and p.K <= cols)
    if B == 8:
        want = {"conv1": ((64, 96), (379, 1, 1)),
                "conv2": ((64, 64), (92, 2, 2))}[name]
        assert direct.conv_tile(p, slab_dtype=bf16) == want[0]
        assert direct.conv_grid(p, B, slab_dtype=bf16) == want[1]
        assert direct.scratch_shape(p, B, lrn, (3, 2), slab_dtype=bf16) \
            == (B, p.out_h, p.out_w, p.Kfull)
    for tile in ((128, 64), (128, 96), (32, 64)):
        with pytest.raises(ValueError, match="tensor-core"):
            direct.conv_tile(p, *tile, slab_dtype=bf16)


def test_conv1_lrn_moves_stage_with_the_tile():
    """conv1 (K = 96): at 96 or more columns the conv stage applies the
    LRN; at 64 the second launch does, from the same conv map."""
    kernel, p, lrn = _kernel_plan(*FULL_LAYERS[0][1:2], 8, 227, 3, 96, False)
    assert kernel == "cuda-direct"
    assert direct.conv_tile(p) == (64, 96)
    assert [direct.lrn_in_conv_stage(p, lrn, t) for t in direct.TILES] == [
        False, True, True, False, True]
    assert direct.scratch_shape(p, 8, lrn, (3, 2), (64, 64)) == (
        8, 55, 55, 96)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
class _Clock:
    """A clock that advances by scripted call durations (seconds)."""

    def __init__(self, durations):
        self.durations, self.t, self.start = list(durations), 0.0, True

    def __call__(self):
        if self.start:
            self.start = False
        else:
            self.t += self.durations.pop(0)
            self.start = True
        return self.t


def test_measure_takes_the_median_of_injected_durations():
    calls = []
    t = timing.measure(lambda: calls.append(1), warmup=2, iters=5,
                       clock=_Clock([3.1e-6, 2.9e-6, 3e-6, 2.95e-6,
                                     3.05e-6]))
    assert len(calls) == 7                  # 2 warm-up calls + 5 samples
    assert t.us == pytest.approx(3.0) and t.rounds == 1 and t.steady
    assert t.samples == pytest.approx((2.9, 2.95, 3.0, 3.05, 3.1))
    assert t.spread == pytest.approx((3.05 - 2.95) / 3.0)
    assert float(t) == t.us


def test_measure_takes_more_rounds_until_steady():
    noisy = [1e-6, 9e-6, 1e-6, 9e-6]
    steady = [5e-6] * 4
    t = timing.measure(lambda: None, warmup=0, iters=4,
                       clock=_Clock(noisy + steady + steady))
    assert t.rounds == 3 and len(t.samples) == 12
    assert t.us == pytest.approx(5.0)
    t = timing.measure(lambda: None, warmup=0, iters=4, max_rounds=2,
                       clock=_Clock(noisy + noisy))
    assert t.rounds == 2 and not t.steady
    assert timing.measure_us(lambda: None, iters=2) >= 0.0


def test_measure_on_cpu_tensors_is_wall_time():
    x = torch.ones(8)
    t = timing.measure(lambda x: x * 2, x, iters=3)
    assert t.us > 0 and len(t.samples) >= 3


# ---------------------------------------------------------------------------
# end to end: tune, persist, load, serve
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tuned_reduced(tmp_path_factory):
    """The reduced AlexNet at image 67 (at the reference's 35 the features
    are empty) tuned on the CPU, its cache saved."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True)
    cache = at.PlanCache()
    results = at.autotune_alexnet(cfg, 2, device="cpu", iters=1,
                                  max_candidates=3, check_equal=True,
                                  hill_climb=True, cache=cache)
    path = cache.save(tmp_path_factory.mktemp("plans") / "alexnet.json")
    return cfg, results, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotune_alexnet_draws_inputs_in_the_config_dtype(dtype,
                                                           monkeypatch):
    """As the reference does (``jax.random.normal`` in ``cfg.dtype``), the
    layer inputs are drawn in the config's dtype, so a bf16 config's plans
    are timed on bf16 launches, under keys that carry its dtype."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, dtype=dtype)
    seen, real = [], at.autotune_layer

    def spy(spec, x, w, b=None, **kw):
        seen.append((x.dtype, w.dtype, b.dtype))
        return real(spec, x, w, b, **kw)

    monkeypatch.setattr(at, "autotune_layer", spy)
    results = at.autotune_alexnet(cfg, 2, device="cpu", iters=1,
                                  max_candidates=1)
    want = getattr(torch, dtype)
    assert len(seen) == 5 and all(d == (want,) * 3 for d in seen)
    assert all(r["key"]["dtype"] == dtype for r in results)


def test_autotune_alexnet_rows(tuned_reduced):
    cfg, results, _ = tuned_reduced
    assert [r["layer"] for r in results] == [f"conv{i}" for i in range(1, 6)]
    for r in results:
        assert r["tuned_us"] <= r["default_us"]
        assert r["rows"][0]["default"] and r["candidates"] == len(r["rows"])
        assert r["key"]["backend"] == "cpu"
        best = min(r["rows"], key=lambda row: row["us"])
        assert best["tile"] == r["tile"]


def test_autotune_persists_reloads_and_applies_bit_equal(tuned_reduced):
    cfg, _, path = tuned_reduced
    plans = alexnet.load_tuned_plans(cfg, 2, path=path, device="cpu")
    assert sorted(plans) == [f"conv{i}" for i in range(1, 6)]
    assert alexnet.load_tuned_plans(cfg, 4, path=path, device="cpu") == plans
    # keyed to the CPU: no plan for another backend
    key = next(iter(json.loads(open(path).read())["entries"].values()))
    assert key["key"]["backend"] == "cpu"
    params = alexnet.init(0, cfg, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
            np.float32))
    y0 = alexnet.apply(params, cfg, imgs)
    y1 = alexnet.apply(params, cfg, imgs, plans=plans)
    assert torch.equal(_bits(y0), _bits(y1))


def test_engine_loads_the_cache_and_serves_the_same_bits(tuned_reduced,
                                                         tmp_path):
    cfg, _, path = tuned_reduced
    params = alexnet.init(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((cfg.image_size, cfg.image_size,
                                   cfg.in_channels)).astype(np.float32)
              for _ in range(3)]
    empty = at.PlanCache().save(tmp_path / "empty.json")
    engines = [CnnEngine(cfg, CnnServeConfig(max_batch=2, plan_cache=path),
                         params=params, device="cpu"),
               CnnEngine(cfg, CnnServeConfig(max_batch=2, plan_cache=empty),
                         params=params, device="cpu")]
    served = []
    for eng in engines:
        reqs = [ImageRequest(image=im) for im in images]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        served.append(np.stack([r.logits for r in reqs]))
    assert engines[0].stats()["tuned_layers"] == [f"conv{i}"
                                                  for i in range(1, 6)]
    assert engines[1].stats()["tuned_layers"] == []
    assert np.array_equal(served[0].view(np.int32), served[1].view(np.int32))


def test_check_equal_catches_a_candidate_that_differs(monkeypatch):
    """``check_equal`` is a real check: a candidate whose output moved by
    one ulp raises."""
    _, kw, H, c_in, c_out = ALEXNET_LAYERS[2]
    x, w, b = (torch.from_numpy(a) for a in _arrays(kw, 9, c_in, c_out))
    spec = t_conv.ConvSpec(route="pallas", **kw)
    real = t_conv.dispatch_conv

    def nudged(*args, plan=None, **kwargs):
        y = real(*args, plan=plan, **kwargs)
        if plan is not None and plan.tile_rows == 32:
            y = torch.nextafter(y, torch.full_like(y, np.inf))
        return y
    monkeypatch.setattr(at, "dispatch_conv", nudged)
    with pytest.raises(AssertionError, match="not bit-equal"):
        at.autotune_layer(spec, x, w, b, iters=1, check_equal=True)


def test_cli_check_passes_on_the_committed_cache_and_fails_otherwise(
        tmp_path, capsys):
    """``--check --from-cache`` on the committed cache (keyed to the card
    it was tuned on) passes; a cache with a layer tuned slower than its
    default, or an empty one, fails."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "autotune_alexnet_torch",
        at.PLAN_DIR.parents[1] / "scripts" / "autotune_alexnet_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    committed = at.default_cache_path()
    data = json.loads(open(committed).read())
    assert len(data["entries"]) == 5
    assert all(e["key"]["backend"].startswith("cuda-sm90-")
               and e["key"]["batch"] == 8 and e["key"]["h"] in (227, 27, 13)
               for e in data["entries"].values())
    assert cli.main(["--check", "--from-cache"]) == 0
    bad = at.PlanCache()
    bad.put(_key(), t_conv.DEFAULT_PLAN, {"default_us": 1.0,
                                          "tuned_us": 2.0})
    path = bad.save(tmp_path / "bad.json")
    assert cli.main(["--check", "--from-cache", "--cache", path]) == 1
    assert cli.main(["--check", "--from-cache", "--cache",
                     str(tmp_path / "empty.json")]) == 1
    assert "CHECK_FAILED" in capsys.readouterr().out


def test_measure_plan_times_the_served_dispatch():
    _, kw, H, c_in, c_out = ALEXNET_LAYERS[3]
    x, w, b = (torch.from_numpy(a) for a in _arrays(kw, 9, c_in, c_out))
    spec = t_conv.ConvSpec(route="pallas", **kw)
    t = at.measure_plan(spec, x, w, b, t_conv.ConvPlan(tile_rows=128),
                        iters=2)
    assert isinstance(t, timing.Timing) and t.us > 0


def test_jax_is_not_needed_by_the_port():
    """The port's autotuner and timing import nothing of JAX (the test
    imports both packages; the modules must not)."""
    import repro_torch.core.autotune as m1
    import repro_torch.core.timing as m2
    for m in (m1, m2):
        src = open(m.__file__).read()
        assert "import jax" not in src and "from repro." not in src
    assert jax.__name__ == "jax"
