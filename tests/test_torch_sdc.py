"""The port's silent-data-corruption defense against the JAX package, on
the CPU: ABFT checksums, armed slabs, the kernels' verdicts, slab
fingerprints, the verifying stager, the armed AlexNet forward and the
engine's detect -> repack -> retry loop.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs as its own ``tests/test_sdc.py`` runs it (Pallas in
interpret mode).  The port's kernel wrappers take their plain versions on
a CPU tensor.  Checksums and slab bytes are compared bit for bit; layer
outputs within rtol = atol = 1e-4 (both float32, summed in different
orders); armed against unarmed, bit for bit.  The TPU kernels count a
mismatched lane once per grid block that streams its tile, the port once
a launch, so a single flip gives the port a verdict of exactly 1 and the
reference one of at least 1.
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.conv import dma as j_dma  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro.nn import conv as j_conv  # noqa: E402
from repro.serving import CnnEngine as JCnnEngine  # noqa: E402
from repro.serving import CnnServeConfig as JCnnServeConfig  # noqa: E402
from repro.serving import FaultInjector as JFaultInjector  # noqa: E402
from repro.serving import FaultSpec as JFaultSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv import direct, dma, ops, winograd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 FaultInjector, FaultSpec, ImageRequest,
                                 derive_seed)

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def _geometries(image_size):
    """(name, JAX spec, port spec, input shape, filter shape) of each
    reduced AlexNet layer on route ``pallas``, shapes threaded as the
    model threads them."""
    j_cfg = dataclasses.replace(j_get_config("alexnet").reduced(),
                                image_size=image_size, use_pallas=True)
    t_cfg = dataclasses.replace(get_config("alexnet").reduced(),
                                image_size=image_size, use_pallas=True)
    out = []
    h, c_in = image_size, t_cfg.in_channels
    for i, (j_spec, t_spec, c_out) in enumerate(zip(
            j_alexnet.layer_specs(j_cfg), alexnet.layer_specs(t_cfg),
            t_cfg.conv_channels)):
        k, g = t_spec.kernel, t_spec.groups
        out.append((f"conv{i + 1}", j_spec.with_route("pallas"),
                    t_spec.with_route("pallas"), (2, h, h, c_in),
                    (k, k, c_in // g, c_out)))
        h, c_in = t_spec.out_hw(h), c_out
    return out


# image 67 keeps all five layers on a kernel (at smaller images conv5's
# fused pool exceeds its output and runs the direct route)
GEOMS = _geometries(67)
IDS = [g[0] for g in GEOMS]


def _layer(name, seed=0):
    """(x, w, b) numpy for one of GEOMS."""
    _, _, _, in_shape, w_shape = GEOMS[IDS.index(name)]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(in_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.1).astype(np.float32)
    b = (rng.standard_normal((w_shape[-1],)) * 0.1).astype(np.float32)
    return x, w, b


def _flip(data, bit):
    """A copy of a tensor or array with bit ``bit`` of its bytes flipped."""
    is_t = isinstance(data, torch.Tensor)
    host = (data.contiguous().clone().view(torch.uint8).numpy() if is_t
            else np.array(data).view(np.uint8))
    flat = host.reshape(-1)
    flat[bit // 8] ^= np.uint8(1 << (bit % 8))
    if is_t:
        return torch.from_numpy(host).view(data.dtype).reshape(data.shape)
    return host.view(np.asarray(data).dtype).reshape(np.shape(data))


def _nbits(t):
    return t.numel() * t.element_size() * 8


def _bits(t):
    """A tensor's bytes as numpy uint8 (any dtype, bf16 included)."""
    return t.contiguous().view(torch.uint8).numpy()


def _to_torch(a, dtype):
    """numpy f32 -> torch ``dtype``; bf16 rounds as JAX rounds it."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _to_jax(t):
    """The same bits as a JAX array (no float round trip: NaN payloads
    survive)."""
    np_dtype = np.float32 if t.dtype is torch.float32 else jnp.bfloat16
    return jnp.asarray(_bits(t).view(np_dtype).reshape(t.shape))


def _wrap_tiles(dtype, shape, seed):
    """Tiles whose columns overflow the checksum's width: large bit
    patterns, NaN payloads, -0.0, negatives, so the sums wrap around."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 1e30).astype(np.float32)
    t = _to_torch(a, dtype)
    itype = dma.checksum_int_dtype(dtype)
    bits = t.view(itype)
    top = torch.iinfo(itype)
    bits[..., 0] = top.max                      # a NaN pattern
    bits[..., 1] = -1                           # all ones
    bits[..., 2] = top.min                      # -0.0
    bits[..., 3] = top.max - 7                  # NaN with another payload
    # a column whose checksum is a NaN pattern with a payload
    nan = 0x7FC00001 if itype is torch.int32 else 0x7FC1
    bits[..., 4] = 0
    bits[..., 0, 4] = nan
    return bits.view(dtype)


@pytest.fixture
def exact_jax_exp2(monkeypatch):
    """The JAX package's BFP code with ``jnp.exp2`` exact for the integer
    arguments it is given (as in tests/test_torch_bfp.py)."""
    def exp2(v):
        v = jnp.asarray(v)
        return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                         jnp.round(v).astype(jnp.int32))
    jax.clear_caches()
    monkeypatch.setattr(jnp, "exp2", exp2)
    yield
    monkeypatch.undo()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# checksum arithmetic, bit for bit against the reference
# ---------------------------------------------------------------------------
def test_checksum_int_dtype():
    assert dma.checksum_int_dtype(torch.float32) is torch.int32
    assert dma.checksum_int_dtype(torch.bfloat16) is torch.int16
    assert dma.checksum_int_dtype(torch.float16) is torch.int16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checksums_bit_equal_to_reference(dtype):
    """tile_checksum and append_checksum_row on tiles whose column sums
    wrap around: the same bits as the reference's."""
    tiles = _wrap_tiles(dtype, (3, 2, 2, 9, 16), seed=0)
    j_tiles = _to_jax(tiles)
    assert np.array_equal(np.asarray(j_tiles).view(np.uint8),
                          _bits(tiles))        # same inputs, bit for bit
    itype = dma.checksum_int_dtype(dtype)
    got = dma.tile_checksum(tiles)
    assert got.dtype is itype and tuple(got.shape) == (3, 2, 2, 16)
    want = np.asarray(j_dma.tile_checksum(j_tiles))
    assert np.array_equal(got.numpy(), want)
    slab = dma.append_checksum_row(tiles)
    assert slab.dtype is dtype and tuple(slab.shape) == (3, 2, 2, 10, 16)
    assert int(dma.checksum_mismatches(slab)) == 0
    word = np.uint32 if dtype is torch.float32 else np.uint16
    have = _bits(slab).view(word)
    want = np.asarray(j_dma.append_checksum_row(j_tiles)).view(word)
    if dtype is torch.float32:
        assert np.array_equal(have, want)
        return
    # the reference's bf16 concatenate (XLA on the CPU) replaces every NaN
    # pattern, weights' and checksums' alike, with the canonical NaN of its
    # sign, so its own clean slab then mismatches (ROADMAP Queue 3); the
    # port keeps the bits
    nan = (have & 0x7F80 == 0x7F80) & (have & 0x7F != 0)
    assert nan[..., -1, 4].all()
    assert np.array_equal(have[~nan], want[~nan])
    assert np.array_equal(want[nan], (have[nan] & 0x8000) | 0x7FC0)
    assert int(j_dma.checksum_mismatches(jnp.asarray(
        want.view(jnp.bfloat16)))) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checksum_mismatches_equal_reference(dtype):
    """Corrupted slabs (flips in data and checksum rows, several in one
    lane): the port counts the same mismatched lanes as the reference."""
    slab = dma.append_checksum_row(_wrap_tiles(dtype, (2, 3, 3, 5, 8), 1))
    rng = np.random.default_rng(2)
    bad = slab
    for bit in rng.integers(0, _nbits(slab), size=12):
        bad = _flip(bad, int(bit))
    j_bad = _to_jax(bad)
    want = int(jax.vmap(j_dma.checksum_mismatches)(j_bad).sum())
    got = int(dma.checksum_mismatches(bad))
    assert got == want > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_every_single_bit_flip_is_one_mismatched_lane(dtype):
    """Every bit of a small armed slab, the checksum rows included: one
    flip makes exactly one lane mismatch."""
    rng = np.random.default_rng(3)
    tiles = _to_torch(rng.standard_normal((2, 2, 2, 3, 4)), dtype)
    slab = dma.append_checksum_row(tiles)
    assert int(dma.checksum_mismatches(slab)) == 0
    for bit in range(_nbits(slab)):
        assert int(dma.checksum_mismatches(_flip(slab, bit))) == 1, bit


def test_checksum_ignores_row_order_not_values():
    """Wraparound integer addition is order-free: swapping two rows is not
    flagged, changing a value is (the reference's contract)."""
    rng = np.random.default_rng(1)
    slab = dma.append_checksum_row(torch.from_numpy(
        rng.standard_normal((1, 6, 6, 4, 8)).astype(np.float32)))
    swapped = slab.clone()
    swapped[..., [0, 1], :] = slab[..., [1, 0], :]
    assert int(dma.checksum_mismatches(swapped)) == 0
    changed = slab.clone()
    changed[0, 0, 0, 0, 0] *= 2.0
    assert int(dma.checksum_mismatches(changed)) == 1


# ---------------------------------------------------------------------------
# armed slabs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,j_spec,t_spec,in_shape,w_shape", GEOMS,
                         ids=IDS)
def test_armed_slab_matches_reference(name, j_spec, t_spec, in_shape,
                                      w_shape):
    """The armed slab is the unarmed one with a checksum row appended to
    every tile.  The direct kernel's slab is a re-layout, so it is the
    reference's byte for byte; a Winograd slab holds G w G^T, which the
    two packages round apart by up to 1e-6, so there the checksum rows
    are held over the reference's own rows."""
    _, w, _ = _layer(name)
    ref = j_conv.pack_conv_weights(j_spec, in_shape, jnp.asarray(w),
                                   abft=True)
    got = t_conv.pack_conv_weights(t_spec, in_shape, torch.from_numpy(w),
                                   abft=True)
    plain = t_conv.pack_conv_weights(t_spec, in_shape, torch.from_numpy(w))
    want = np.asarray(ref.data)
    assert tuple(got.data.shape) == want.shape
    assert got.data.shape[-2] == plain.data.shape[-2] + 1
    assert torch.equal(got.data, dma.append_checksum_row(plain.data))
    if got.kernel == "cuda-direct":
        assert np.array_equal(_bits(got.data), want.view(np.uint8))
    else:
        np.testing.assert_allclose(got.data[..., :-1, :].numpy(),
                                   want[..., :-1, :], rtol=0, atol=1e-6)
    rows = torch.from_numpy(np.ascontiguousarray(want[..., :-1, :]))
    assert np.array_equal(_bits(dma.append_checksum_row(rows)),
                          want.view(np.uint8))


@pytest.mark.parametrize("name", ["conv2", "conv3"])
def test_armed_bfp_slab_matches_reference(exact_jax_exp2, name):
    """conv_bfp + ABFT: the checksum row covers the quantized rows (taken
    off, quantized, computed again), as in the reference; conv2's direct
    slab is its bytes, conv3's checksums over the reference's rows."""
    _, j_spec, t_spec, in_shape, _ = GEOMS[IDS.index(name)]
    _, w, _ = _layer(name, seed=5)
    ref = np.asarray(j_conv.pack_conv_weights(
        j_spec, in_shape, jnp.asarray(w), bfp_pack=True, abft=True).data)
    got = t_conv.pack_conv_weights(t_spec, in_shape, torch.from_numpy(w),
                                   bfp_pack=True, abft=True)
    bfp_rows = t_conv.pack_conv_weights(t_spec, in_shape,
                                        torch.from_numpy(w),
                                        bfp_pack=True).data
    assert got.bfp and int(dma.checksum_mismatches(got.data)) == 0
    assert torch.equal(got.data[..., :-1, :], bfp_rows)
    if name == "conv2":
        assert np.array_equal(_bits(got.data), ref.view(np.uint8))
    rows = torch.from_numpy(np.ascontiguousarray(ref[..., :-1, :]))
    assert np.array_equal(_bits(dma.append_checksum_row(rows)),
                          ref.view(np.uint8))


@pytest.mark.parametrize("kind", ["direct", "winograd"])
def test_armed_plan_blocks_as_unarmed(kind):
    """The armed plan derives the same blocking; only the tile grows a
    row, and unpacking an armed slab strips it."""
    name = "conv2" if kind == "direct" else "conv4"
    _, _, t_spec, in_shape, w_shape = GEOMS[IDS.index(name)]
    mod = direct if kind == "direct" else winograd
    kw = (dict(stride=1, groups=2, pool=(3, 2)) if kind == "direct"
          else dict(groups=2))
    p0 = mod.plan(in_shape, w_shape, **kw)
    p1 = mod.plan(in_shape, w_shape, checksum=True, **kw)
    assert dataclasses.replace(p1, checksum=False) == p0
    assert p1.weights.tile_shape == (*p0.weights.tile_shape[:-2],
                                     p0.Cb + 1, p0.Kb)
    assert p1.weights.tap_rows == p0.Cb + 1 and p0.weights.tap_rows == p0.Cb
    _, w, _ = _layer(name)
    slab = mod.pack_weights(torch.from_numpy(w), p1)
    assert torch.equal(dma.unpack_weight_tiles(slab, p1.weights),
                       dma.unpack_weight_tiles(
                           mod.pack_weights(torch.from_numpy(w), p0),
                           p0.weights))


# ---------------------------------------------------------------------------
# the armed conv entries and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,j_spec,t_spec,in_shape,w_shape", GEOMS,
                         ids=IDS)
def test_dispatch_abft_clean_and_flip_vs_reference(name, j_spec, t_spec,
                                                   in_shape, w_shape):
    """Armed clean: bit-equal to unarmed, verdict 0, and within TOL of the
    reference's armed output.  One seeded flip anywhere in the slab: the
    port's verdict is 1 where the reference's is above 0."""
    x, w, b = _layer(name, seed=IDS.index(name))
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    j_pw = j_conv.pack_conv_weights(j_spec, in_shape, jw, abft=True)
    t_pw = t_conv.pack_conv_weights(t_spec, in_shape, tw, abft=True)
    assert t_pw.kernel == j_pw.kernel.replace("pallas-", "cuda-")

    y0 = t_conv.dispatch_conv(t_spec, tx, tw, tb)
    y1, v = t_conv.dispatch_conv(t_spec, tx, tw, tb, w_packed=t_pw,
                                 abft=True)
    assert torch.equal(y0, y1), "armed clean path diverged"
    assert v.dtype is torch.int32 and v.shape == () and int(v) == 0
    j_y, j_v = j_conv.dispatch_conv(j_spec, jx, jw, jb, w_packed=j_pw,
                                    abft=True, interpret=True)
    assert int(j_v) == 0
    np.testing.assert_allclose(y1.numpy(), np.asarray(j_y), **TOL)

    bit = int(np.random.default_rng(17).integers(_nbits(t_pw.data)))
    bad = dataclasses.replace(t_pw, data=_flip(t_pw.data, bit))
    _, v_bad = t_conv.dispatch_conv(t_spec, tx, tw, tb, w_packed=bad,
                                    abft=True)
    j_bad = dataclasses.replace(j_pw, data=jnp.asarray(
        _flip(np.asarray(j_pw.data), bit)))
    _, j_v_bad = j_conv.dispatch_conv(j_spec, jx, jw, jb, w_packed=j_bad,
                                      abft=True, interpret=True)
    assert int(j_v_bad) > 0 and int(v_bad) == 1, (name, bit)


def _slab_regions(pw, p):
    """Bit positions in an armed slab: one in a checksum row, one in a
    channel padding row (None when the plan pads no channel), one sign
    and one exponent bit of a weight."""
    shape = tuple(pw.data.shape)                  # (n, *spatial, Cb+1, Kb)
    idx = np.arange(pw.data.numel()).reshape(shape)
    word = {"checksum": idx[-1, ..., -1, 1].reshape(-1)[0],
            "weight": idx[0, ..., 0, 0].reshape(-1)[0]}
    pad = p.Cp - p.C
    pos = {"checksum": 32 * word["checksum"] + 5,
           "sign": 32 * word["weight"] + 31,
           "exponent": 32 * word["weight"] + 27}
    if pad:
        # channel C of group 0 lies in C block C // Cb at row C % Cb
        row = idx[p.C // p.Cb, ..., p.C % p.Cb, 0].reshape(-1)[0]
        pos["padding"] = 32 * row + 3
    return pos


@pytest.mark.parametrize("name,j_spec,t_spec,in_shape,w_shape", GEOMS,
                         ids=IDS)
def test_every_seeded_flip_is_counted_once(name, j_spec, t_spec, in_shape,
                                           w_shape):
    """32 seeded single-bit flips over the whole slab plus one in a
    checksum row, a padding row where the plan has one, a sign and an
    exponent bit: each verdict is 1 (one lane); two flips in different
    lanes count 2."""
    x, w, b = (torch.from_numpy(a) for a in _layer(name, seed=7))
    pw = t_conv.pack_conv_weights(t_spec, in_shape, w, abft=True)
    lrn, pool = t_conv._spec_fusion(t_spec)
    p = t_conv._kernel_weight_plan(t_spec, pw.kernel, in_shape,
                                   tuple(w.shape), lrn=lrn, pool=pool,
                                   knobs=t_conv.plan_knobs(), abft=True)
    nbits = _nbits(pw.data)
    rng = np.random.default_rng(100 + IDS.index(name))
    bits = [int(v) for v in rng.integers(0, nbits, size=32)]
    bits += list(_slab_regions(pw, p).values())
    y0 = t_conv.dispatch_conv(t_spec, x, w, b)
    for bit in bits:
        bad = dataclasses.replace(pw, data=_flip(pw.data, bit))
        y, v = t_conv.dispatch_conv(t_spec, x, w, b, w_packed=bad, abft=True)
        assert int(v) == 1, (name, bit)
    # two flips a tile apart: two lanes
    lane_bits = 32 * pw.data[0].numel()
    two = _flip(_flip(pw.data, 0), lane_bits if pw.data.shape[0] > 1
                else 32 * pw.data.shape[-1] * pw.data.shape[-2])
    _, v = t_conv.dispatch_conv(t_spec, x, w, b,
                                w_packed=dataclasses.replace(pw, data=two),
                                abft=True)
    assert int(v) == 2
    assert y0.shape == y.shape


def test_padding_row_flip_is_caught():
    """A layer whose channels do not fill the last C block: the flip in a
    padding row, which no GEMM reads, still counts."""
    spec = t_conv.ConvSpec(kernel=3, relu=True, route="pallas")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 5)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 8)).astype(
        np.float32))
    pw = t_conv.pack_conv_weights(spec, tuple(x.shape), w, abft=True,
                                  plan=t_conv.ConvPlan(c_block=4))
    p = winograd.plan(tuple(x.shape), tuple(w.shape), c_block=4,
                      checksum=True)
    assert p.Cp > p.C
    bit = _slab_regions(pw, p)["padding"]
    y0 = t_conv.dispatch_conv(spec, x, w, None, plan=t_conv.ConvPlan(
        c_block=4))
    y, v = t_conv.dispatch_conv(spec, x, w, None, abft=True,
                                plan=t_conv.ConvPlan(c_block=4),
                                w_packed=dataclasses.replace(
                                    pw, data=_flip(pw.data, bit)))
    assert int(v) == 1 and torch.equal(y, y0)


@pytest.mark.parametrize("kind", ["direct", "winograd"])
def test_verdict_adds_into_the_callers_tensor(kind):
    """An armed call adds its count to the verdict it is given (a forward
    sums its five layers into one); without one it returns a fresh int32
    zero plus its count."""
    name = "conv2" if kind == "direct" else "conv3"
    _, _, t_spec, in_shape, w_shape = GEOMS[IDS.index(name)]
    x, w, b = (torch.from_numpy(a) for a in _layer(name))
    fn = direct.conv2d_direct if kind == "direct" else \
        winograd.conv2d_winograd
    kw = (dict(groups=2, padding="SAME", relu=True,
               lrn=t_spec.lrn, pool=(3, 2)) if kind == "direct"
          else dict(relu=True))
    y0 = fn(x, w, b, **kw)
    y, v = fn(x, w, b, checksum=True, **kw)
    assert torch.equal(y, y0) and int(v) == 0 and v.dtype is torch.int32
    p = (direct.plan(in_shape, w_shape, groups=2, pool=(3, 2),
                     checksum=True) if kind == "direct"
         else winograd.plan(in_shape, w_shape, checksum=True))
    # two flips in tile 0's first checksum row: two lanes, and no weight
    # the conv reads changes
    row = 32 * p.Cb * p.Kb
    slab = _flip(_flip(mod_pack(kind)(w, p), row + 3), row + 32 * 5 + 30)
    acc = torch.tensor(3, dtype=torch.int32)
    y, v = fn(x, w, b, slab, checksum=True, verdict=acc, **kw)
    assert v is acc and int(acc) == 5
    assert torch.equal(y, y0)


def mod_pack(kind):
    return direct.pack_weights if kind == "direct" else winograd.pack_weights


@pytest.mark.parametrize("route", ["direct", "winograd"])
def test_slabless_routes_give_a_zero_verdict(route):
    """The routes without a slab have nothing to check: their verdict is
    0, or the caller's verdict unchanged, as in the reference."""
    spec = t_conv.ConvSpec(kernel=3, relu=True, route=route)
    x, w, b = (torch.from_numpy(a) for a in _layer("conv3"))
    y0 = t_conv.dispatch_conv(spec, x, w, b)
    y, v = t_conv.dispatch_conv(spec, x, w, b, abft=True)
    assert torch.equal(y, y0) and int(v) == 0 and v.dtype is torch.int32
    acc = torch.tensor(4, dtype=torch.int32)
    _, v = t_conv.dispatch_conv(spec, x, w, b, abft=True, verdict=acc)
    assert v is acc and int(acc) == 4
    conv = ops.conv2d if route == "winograd" else ops.conv2d_direct
    y, v = conv(x, w, b, relu=True, checksum=True, pallas=False)
    assert int(v) == 0


def test_bfp_slab_abft_clean_and_flip():
    """A conv_bfp slab armed: clean output bit-equal to the unarmed BFP
    slab's, verdict 0; a flip in the quantized slab counts."""
    _, _, t_spec, in_shape, _ = GEOMS[2]
    x, w, _ = (torch.from_numpy(a) for a in _layer("conv3", seed=5))
    pw = t_conv.pack_conv_weights(t_spec, in_shape, w, bfp_pack=True,
                                  abft=True)
    y0 = t_conv.dispatch_conv(t_spec, x, w, None, w_packed=(
        t_conv.pack_conv_weights(t_spec, in_shape, w, bfp_pack=True)))
    y1, v = t_conv.dispatch_conv(t_spec, x, w, None, w_packed=pw, abft=True)
    assert torch.equal(y0, y1) and int(v) == 0
    _, v = t_conv.dispatch_conv(t_spec, x, w, None, abft=True,
                                w_packed=dataclasses.replace(
                                    pw, data=_flip(pw.data, 12345)))
    assert int(v) == 1


def test_abft_launch_geometry():
    """What the armed launch hands the C launcher: the slab's row stride
    Cs = Cb + 1, the verdict's address, and 256 more ints of shared memory
    a block (abft.cuh's partial sums)."""
    for name in IDS:
        _, _, t_spec, in_shape, w_shape = GEOMS[IDS.index(name)]
        lrn, pool = t_conv._spec_fusion(t_spec)
        kernel = t_conv.resolve_kernel(t_spec, in_hw=in_shape[1])
        p0, p1 = (t_conv._kernel_weight_plan(
            t_spec, kernel, in_shape, w_shape, lrn=lrn, pool=pool,
            knobs=t_conv.plan_knobs(), abft=armed) for armed in (False,
                                                                  True))
        mod = direct if kernel == "cuda-direct" else winograd
        assert mod.smem_bytes(p1) == mod.smem_bytes(p0) + 4 * 256
        x = torch.zeros(in_shape)
        verdict = torch.zeros((), dtype=torch.int32)
        a0 = direct.conv_args(x, p0, relu=True, lrn=lrn, pool=pool, PT=1,
                              pad=(0, 0), out_hw=(1, 1))
        a1 = direct.conv_args(x, p1, relu=True, lrn=lrn, pool=pool, PT=1,
                              pad=(0, 0), out_hw=(1, 1), verdict=verdict)
        assert (a0.Cs, a1.Cs) == (p0.Cb, p0.Cb + 1)
        assert a0.verdict is None and a1.verdict == verdict.data_ptr()
    # the pointer is the struct's last field, 8-byte aligned as in C
    assert build.ConvArgs._fields_[-1] == ("verdict", ctypes.c_void_p)
    assert build.ConvArgs.verdict.offset % 8 == 0


def test_armed_cuda_wrapper_checks_the_verdict():
    """The CUDA wrappers refuse a verdict that is not one int32 on the
    input's device before any launch."""
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((2,))
    for bad in (torch.zeros((), dtype=torch.int64),
                torch.zeros((2,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="verdict"):
            direct.check_cuda_inputs("conv_direct", x, x, w, 2, bad)


# ---------------------------------------------------------------------------
# slab fingerprints and the verifying stager
# ---------------------------------------------------------------------------
def test_fingerprint_catches_flip_shape_and_context():
    _, _, t_spec, in_shape, _ = GEOMS[3]
    w = torch.from_numpy(_layer("conv4", seed=7)[1])
    pw = t_conv.pack_conv_weights(t_spec, in_shape, w, abft=True,
                                  fingerprint=True)
    assert t_conv.verify_packed(pw)
    assert not t_conv.verify_packed(dataclasses.replace(
        pw, data=_flip(pw.data, 99)))
    assert not t_conv.verify_packed(dataclasses.replace(
        pw, data=pw.data[:-1]))
    ctx = t_conv.expected_pack_context(t_spec, in_shape, abft=True)
    assert pw.fingerprint.context == ctx
    assert pw.fingerprint.matches(pw, expect=ctx)
    other = t_conv.expected_pack_context(t_spec, in_shape, abft=False)
    assert not pw.fingerprint.matches(pw, expect=other)
    # unfingerprinted slabs pass: the check is opt-in
    assert t_conv.verify_packed(t_conv.pack_conv_weights(t_spec, in_shape, w,
                                                         abft=True))
    assert t_conv.slab_fingerprint(None) is None


def test_fingerprint_is_the_references():
    """On the same bytes (the direct kernel's slab) the fingerprint's
    shape, dtype name and crc32 are the reference's; the contexts differ
    only by the datapath's name."""
    _, j_spec, t_spec, in_shape, _ = GEOMS[1]
    w = _layer("conv2", seed=7)[1]
    ref = j_conv.pack_conv_weights(j_spec, in_shape, jnp.asarray(w),
                                   abft=True, fingerprint=True).fingerprint
    got = t_conv.pack_conv_weights(t_spec, in_shape, torch.from_numpy(w),
                                   abft=True, fingerprint=True).fingerprint
    assert (got.shape, got.dtype, got.crc32) == (
        tuple(ref.shape), ref.dtype, ref.crc32)
    assert got.context == ref.context.replace("pallas-", "cuda-")


def test_stager_cache_hit_verification_repacks():
    """A verifying stager catches a corrupted or contextually stale cached
    slab on the hit path and repacks it; a plain stager serves the hit."""
    _, _, t_spec, in_shape, _ = GEOMS[2]
    w = torch.from_numpy(_layer("conv3", seed=13)[1])
    stager = dma.WeightStager(verify=True)
    ctx = t_conv.expected_pack_context(t_spec, in_shape, abft=True)

    def pack(expect=ctx):
        return stager.stage("k", t_conv.pack_conv_weights, t_spec, in_shape,
                            w, abft=True, fingerprint=True, expect=expect)

    first = pack()
    assert stager.misses == 1
    assert pack() is first and stager.hits == 1
    stager._cache["k"] = dataclasses.replace(first,
                                             data=_flip(first.data, 4242))
    again = pack()
    assert stager.integrity_failures == 1 and stager.misses == 2
    assert t_conv.verify_packed(again) and torch.equal(again.data,
                                                       first.data)
    pack(t_conv.expected_pack_context(t_spec, in_shape, abft=False))
    assert stager.integrity_failures == 2
    plain = dma.WeightStager()
    plain._cache["k"] = dataclasses.replace(first, data=_flip(first.data, 7))
    assert plain.stage("k", t_conv.pack_conv_weights, t_spec, in_shape, w,
                       abft=True) is plain._cache["k"]


# ---------------------------------------------------------------------------
# the armed AlexNet forward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    """The reduced AlexNet (image 67, route pallas) in both packages with
    the reference's parameters, and two numpy images."""
    j_cfg = dataclasses.replace(j_get_config("alexnet").reduced(),
                                use_pallas=True)
    t_cfg = dataclasses.replace(get_config("alexnet").reduced(),
                                use_pallas=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    imgs = np.random.default_rng(0).standard_normal(
        (2, 67, 67, 3)).astype(np.float32)
    return j_cfg, t_cfg, np_params, imgs


def test_alexnet_abft_forward_matches_reference(reduced):
    """sdc_abft: (logits, sdc) with sdc 0 in both packages, the port's
    logits bit-equal to its unarmed forward and within TOL of the
    reference's armed logits."""
    j_cfg, t_cfg, np_params, imgs = reduced
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(imgs)
    plain = alexnet.apply(params, t_cfg, x)
    armed = dataclasses.replace(t_cfg, sdc_abft=True)
    logits, sdc = alexnet.apply(params, armed, x)
    assert torch.equal(logits, plain)
    assert sdc.dtype is torch.int32 and int(sdc) == 0
    j_logits, j_sdc = j_alexnet.apply(
        np_params, dataclasses.replace(j_cfg, sdc_abft=True),
        jnp.asarray(imgs))
    assert int(j_sdc) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)


def test_alexnet_abft_packed_and_verifying_stager(reduced):
    """The pack-once path, a verifying stager and a flipped packed slab:
    bit-equal logits when clean; a flip anywhere in one layer's slab gives
    sdc 1 (the verdict of all five layers sums into one tensor)."""
    _, t_cfg, np_params, imgs = reduced
    params = alexnet.params_from_numpy(np_params, device="cpu")
    cfg = dataclasses.replace(t_cfg, sdc_abft=True)
    x = torch.from_numpy(imgs)
    want, _ = alexnet.apply(params, cfg, x)
    packed = alexnet.pack_serving_slabs(params, cfg, 2, fingerprint=True)
    assert all(packed[f"conv{i}"].fingerprint is not None
               for i in range(1, 6))
    logits, sdc = alexnet.apply(params, cfg, x, packed=packed)
    assert torch.equal(logits, want) and int(sdc) == 0
    stager = dma.WeightStager(verify=True)
    for _ in range(2):
        logits, sdc = alexnet.apply(params, cfg, x, stager=stager)
        assert torch.equal(logits, want) and int(sdc) == 0
    assert stager.misses == 5 and stager.integrity_failures == 0
    for name in ("conv1", "conv4"):
        pw = packed[name]
        bad = {**packed, name: dataclasses.replace(
            pw, data=_flip(pw.data, 777))}
        _, sdc = alexnet.apply(params, cfg, x, packed=bad)
        assert int(sdc) == 1, name


# ---------------------------------------------------------------------------
# the engine: detect -> repack -> retry, never serve a tainted row
# ---------------------------------------------------------------------------
def _scfg(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("retry_backoff_ms", 0.01)
    kw.setdefault("screen_sample", 4)
    return CnnServeConfig(**kw)


def _serve(eng, imgs, retries=5):
    rs = [ImageRequest(image=im, retries=retries) for im in imgs]
    for r in rs:
        eng.submit(r)
    eng.run_until_done()
    return rs


def _balanced(eng):
    acc = eng.accounting()
    return acc["balanced"] and acc["in_flight"] == 0


def _assert_bitmatch(params, cfg, reqs):
    """Each request's logits equal the unarmed ``apply`` on the exact
    padded batch it was served in (the port's CPU plain versions round by
    batch shape, so a row retried alone is held to its own bucket)."""
    plain = dataclasses.replace(cfg, sdc_abft=False)
    by_uid = {r.uid: r for r in reqs}
    for r in reqs:
        x = np.zeros((r.served_bucket, *r.image.shape), np.float32)
        for row, uid in enumerate(r.served_group):
            x[row] = by_uid[uid].image
        want = alexnet.apply(params, plain, torch.from_numpy(x))
        assert np.array_equal(r.logits, want[r.served_row].numpy())


@pytest.fixture(scope="module")
def sdc_served():
    """The armed reduced config (image 67: at the reference's engine tests'
    35 the conv features are empty), seeded params, 8 images, and the
    fault-free armed engine's logits, which equal the unarmed engine's bit
    for bit."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, sdc_abft=True)
    params = alexnet.init(0, cfg, device="cpu")
    rng = np.random.default_rng(42)
    imgs = [rng.standard_normal((67, 67, 3)).astype(np.float32)
            for _ in range(8)]
    oracle = _serve(CnnEngine(cfg, _scfg(), params=params, device="cpu"),
                    imgs)
    unarmed = _serve(CnnEngine(dataclasses.replace(cfg, sdc_abft=False),
                               _scfg(), params=params, device="cpu"), imgs)
    assert all(r.done for r in oracle)
    for a, b in zip(oracle, unarmed):
        assert np.array_equal(a.logits, b.logits)
    return cfg, params, imgs, [r.logits for r in oracle]


def _engine(cfg, params, **kw):
    return CnnEngine(cfg, _scfg(**kw), params=params, device="cpu")


def test_engine_bitflip_detected_before_retire_bitmatch(sdc_served):
    cfg, params, imgs, oracle = sdc_served
    eng = _engine(cfg, params)
    _serve(eng, imgs[:4])
    eng.arm_faults(FaultInjector(seed=derive_seed(0, "flip"),
                                 specs={"slab.bitflip": FaultSpec(at=(0, 1))}))
    eng.reset_metrics()
    rs = _serve(eng, imgs)
    fired = eng.faults.summary()["slab.bitflip"]["fired"]
    assert fired == 2 and eng.sdc_detections == fired
    assert eng.images_retried > 0
    assert all(r.done for r in rs) and _balanced(eng)
    _assert_bitmatch(params, cfg, rs)


def test_engine_verify_slabs_catches_flip_and_stale(sdc_served):
    cfg, params, imgs, oracle = sdc_served
    eng = _engine(cfg, params, verify_slabs=True)
    _serve(eng, imgs[:4])
    eng.arm_faults(FaultInjector(
        seed=derive_seed(0, "stale"),
        specs={"slab.bitflip": FaultSpec(at=(0,)),
               "slab.stale": FaultSpec(at=(1,))}))
    eng.reset_metrics()
    rs = _serve(eng, imgs)
    assert eng.slab_integrity_failures == 2
    assert eng.sdc_detections == 0          # caught before any forward
    assert all(r.done for r in rs) and _balanced(eng)
    _assert_bitmatch(params, cfg, rs)


def test_engine_plausible_corruption_screened(sdc_served):
    cfg, params, imgs, oracle = sdc_served
    eng = _engine(cfg, params, screen_abs_max=1e4)
    _serve(eng, imgs[:4])
    eng.arm_faults(FaultInjector(
        seed=derive_seed(0, "plausible"),
        specs={"retire.plausible": FaultSpec(at=(0,), magnitude=1e6)}))
    eng.reset_metrics()
    rs = _serve(eng, imgs)
    assert eng.screen_magnitude >= 1 and eng.screen_nonfinite == 0
    assert eng.images_retried >= 1
    assert all(r.done for r in rs) and _balanced(eng)
    assert eng.accounting()["screen_magnitude"] == eng.screen_magnitude
    _assert_bitmatch(params, cfg, rs)


def test_engine_armed_idle_sdc_bit_identical(sdc_served):
    cfg, params, imgs, oracle = sdc_served
    eng = _engine(cfg, params, verify_slabs=True, screen_abs_max=1e6)
    eng.arm_faults(FaultInjector(seed=derive_seed(0, "idle"), specs={}))
    rs = _serve(eng, imgs)
    assert eng.sdc_detections == 0 and eng.slab_integrity_failures == 0
    assert eng.screen_magnitude == 0
    for r, want in zip(rs, oracle):      # the same schedule, the same bits
        assert np.array_equal(r.logits, want)


def test_engine_repeated_sdc_failures_degrade_bucket(sdc_served):
    """Consecutive detections on one bucket move it to the direct route
    (no slab to corrupt), recorded as a degradation; all complete."""
    cfg, params, imgs, _ = sdc_served
    eng = _engine(cfg, params, degrade_threshold=3, quarantine_threshold=10)
    _serve(eng, imgs[:4])
    eng.arm_faults(FaultInjector(
        seed=derive_seed(0, "degrade"),
        specs={"slab.bitflip": FaultSpec(at=(0, 1, 2))}))
    eng.reset_metrics()
    rs = _serve(eng, imgs[:4], retries=6)
    assert eng.sdc_detections == 3
    assert eng.stats()["degraded_buckets"] == [4]
    assert eng.stats()["degradations"][0]["reason"] == "sdc"
    assert all(r.done for r in rs) and _balanced(eng)


def test_engine_stats_surface_sdc_block(sdc_served):
    cfg, params, imgs, _ = sdc_served
    eng = _engine(cfg, params, verify_slabs=True, screen_abs_max=1e6)
    _serve(eng, imgs[:2])
    assert eng.stats()["sdc"] == {
        "abft_armed": True, "verify_slabs": True, "detections": 0,
        "slab_integrity_failures": 0, "screen_nonfinite": 0,
        "screen_magnitude": 0}
    eng.sdc_detections = eng.slab_integrity_failures = 3
    eng.reset_metrics()
    assert eng.sdc_detections == eng.slab_integrity_failures == 0


def _flipped_position(before: dict, after: dict):
    """(layer, byte, bit) of the one bit that differs between two dicts of
    slabs' bytes."""
    diffs = []
    for name in before:
        xor = np.bitwise_xor(before[name], after[name])
        for byte in np.flatnonzero(xor):
            diffs.append((name, int(byte), int(xor[byte]).bit_length() - 1))
    assert len(diffs) == 1, diffs
    return diffs[0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bitflip_payload_is_the_references(seed):
    """With the same seed the port flips the same (layer, byte, bit) of
    the same bucket's slabs as the reference: the armed slabs have the
    same byte counts and the draws come in the reference's order."""
    j_cfg = dataclasses.replace(j_get_config("alexnet").reduced(),
                                use_pallas=True,
                                sdc_abft=True)
    t_cfg = dataclasses.replace(get_config("alexnet").reduced(),
                                use_pallas=True,
                                sdc_abft=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    spec = {"slab.bitflip": JFaultSpec(at=(0,))}
    j_eng = JCnnEngine(j_cfg, JCnnServeConfig(max_batch=4),
                       params=np_params,
                       faults=JFaultInjector(seed, spec))
    t_eng = CnnEngine(t_cfg, CnnServeConfig(max_batch=4),
                      params=alexnet.params_from_numpy(np_params, "cpu"),
                      faults=FaultInjector(
                          seed, {"slab.bitflip": FaultSpec(at=(0,))}),
                      device="cpu")
    positions = []
    for eng, host in ((j_eng, lambda d: np.array(d).view(np.uint8)
                       .reshape(-1)),
                      (t_eng, lambda d: _bits(d).reshape(-1))):
        names = eng._slab_entries(eng._slabs(4))
        before = {n: host(eng._slabs(4)[n].data) for n in names}
        assert eng.faults.fire("slab.bitflip") is not None
        eng._inject_bitflip(4)
        after = {n: host(eng._packed[4][n].data) for n in names}
        positions.append(_flipped_position(before, after))
    assert positions[0] == positions[1]


def test_stale_payload_is_the_references():
    """``slab.stale`` hands the same victim the same donor's slab as the
    reference, for the same seed."""
    picks = []
    for seed in range(3):
        for mk in ("j", "t"):
            rng = (JFaultInjector if mk == "j" else FaultInjector)(
                seed, {}).payload_rng("slab.stale")
            names = [f"conv{i}" for i in range(1, 5)]
            i = int(rng.integers(len(names)))
            picks.append((seed, mk, names[i], names[(i + 1) % 4]))
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, sdc_abft=True)
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=4),
                    params=alexnet.init(0, cfg, device="cpu"),
                    faults=FaultInjector(1, {"slab.stale":
                                             FaultSpec(at=(0,))}),
                    device="cpu")
    before = dict(eng._slabs(4))
    eng.faults.fire("slab.stale")
    eng._inject_stale(4)
    victim, donor = picks[2][2], picks[2][3]
    assert picks[2][2:] == picks[3][2:]
    assert eng._packed[4][victim].data is before[donor].data
    assert eng._packed[4][victim].fingerprint is before[victim].fingerprint
    assert [p[2:] for p in picks[0::2]] == [p[2:] for p in picks[1::2]]


def test_launcher_sdc_on_the_cpu(capsys):
    """``--sdc`` arms the defense in repro_torch.launch.serve; with
    ``--chaos`` its faults are caught and every request completes."""
    serve.main(["--route", "pallas", "--device", "cpu", "--requests", "6",
                "--sdc", "--chaos", "--seed", "3"])
    out = capsys.readouterr().out
    assert "completed 6/6" in out and "balanced=yes" in out
    assert "sdc abft=on verify_slabs=on" in out
