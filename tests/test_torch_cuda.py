"""The port's CUDA kernels against their plain PyTorch versions.

Marked ``cuda``: they need the card and skip without one.  Each case runs
the kernel wrapper on a CUDA tensor and the same wrapper on a CPU tensor
(which takes the plain version), on numpy-made inputs, across the AlexNet
geometries (reduced and full width) and off-AlexNet blockings: several
channel blocks with channel padding, several K blocks, strides, VALID /
SAME, groups, LRN without pool, pool without LRN.  Tolerance: max|diff| <=
1e-4 * max(1, max|plain|) — both sides FP32, summed in different orders.
The BFP matmul kernel and its plain version sum exact terms in the same
order, so they must agree bit for bit.  Kernel 5 (decode attention) keeps
its probabilities in f32, as the JAX package's TPU kernel does; it is held
against the plain version that does the same within one step of its output
dtype: atol 1e-5, rtol 1e-5 in f32; atol 1e-4, rtol 1e-2 in bf16 (a bf16
step is at most 2**-7 relative).  Against the plain version the models
call, which rounds its probabilities to bf16, it is held to the JAX
package's bound for its decode kernel, rtol = atol = 5e-2 in bf16.
Kernels 6 (the SSD scan) and 7 (the depthwise causal conv) compute in f32
like their plain versions, with the same prefix sum of dt * A: in f32
max|diff| <= 1e-5 * max|plain|; in bf16 the outputs round f32 values that
differ by f32 noise, so they agree within one bf16 step (rtol 2**-7, atol
1e-5 * max|plain|), and the SSD's f32 state within 1e-5 * max|plain|.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp  # noqa: E402
from repro_torch.kernels.bfp_matmul import ops as bfp_ops  # noqa: E402
from repro_torch.kernels.conv import direct, dma, ops, winograd  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import \
    decode_attention_f32_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.models import alexnet, lm  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.nn.pooling import LrnParams  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 Engine, ImageRequest, Request, ServeConfig)

LRN = LrnParams()
POOL = (3, 2)

# (name, kw, B, H, c_in, c_out)
DIRECT_CASES = [
    ("conv1_reduced", dict(stride=4, padding="VALID", lrn=LRN, pool=POOL),
     11, 2, 35, 3, 16),
    ("conv2_reduced", dict(groups=2, lrn=LRN, pool=POOL), 5, 2, 13, 16, 32),
    ("conv1_full", dict(stride=4, padding="VALID", lrn=LRN, pool=POOL),
     11, 8, 227, 3, 96),
    ("conv2_full", dict(groups=2, lrn=LRN, pool=POOL), 5, 8, 27, 96, 256),
    ("s2_same_plain", dict(stride=2), 3, 2, 9, 5, 7),
    ("cblocks_pool2", dict(pool=(2, 2), c_block=2), 1, 2, 8, 5, 40),
    ("kblocks_lrn_g2", dict(groups=2, lrn=LRN, k_block=4), 3, 2, 7, 6, 16),
    # the conv stage's tiling edges: M = 363 pixels (no multiple of a block
    # tile), K = 40 (under one 64-channel tile), C = 5 (4-byte copies)
    ("m_ragged_k40_c5", dict(lrn=LRN, pool=POOL), 3, 3, 11, 5, 40),
    # K = 96 (a full and a half N tile), C = 3, stride 4 VALID
    ("s4_valid_k96_c3", dict(stride=4, padding="VALID", pool=POOL),
     11, 1, 47, 3, 96),
    # SAME r = 5 s = 1: every corner reads padding; no LRN, no pool (the
    # conv stage writes the output, one launch)
    ("same_r5_corners_c5", dict(), 5, 2, 7, 5, 12),
    # 16-byte copies in both groups (C = 4), LRN across the group seam
    ("g2_c4_lrn_pool", dict(groups=2, lrn=LRN, pool=POOL), 5, 2, 12, 8, 24),
    # 16-byte copies over more than one wave (545 blocks of 64 pixels)
    ("big_m_c8_k64", dict(), 3, 8, 66, 8, 64),
    # LRN in the conv stage (one group, K <= the tile's columns), no pool:
    # one launch; with 64 x 96 tiles, as conv1 has them
    ("lrn_in_conv_k40", dict(lrn=LRN), 3, 2, 10, 4, 40),
    ("big_m_k96_lrn_in_conv", dict(lrn=LRN), 3, 8, 66, 4, 96),
    # one group, K = 130 over three column tiles: LRN in the second launch
    ("lrn_k130_epilogue", dict(lrn=LRN), 3, 1, 8, 3, 130),
]

WINO_CASES = [
    ("conv3_reduced", dict(), 2, 13, 32, 48),
    ("conv4_reduced", dict(groups=2), 2, 13, 48, 48),
    ("conv5_reduced", dict(groups=2, pool=POOL), 2, 13, 48, 32),
    ("conv3_full", dict(), 8, 13, 256, 384),
    ("conv4_full", dict(groups=2), 8, 13, 384, 384),
    ("conv5_full", dict(groups=2, pool=POOL), 8, 13, 384, 256),
    ("valid_kpad", dict(padding="VALID", k_block=32), 2, 11, 8, 40),
    ("lrn_only_cblocks", dict(lrn=LRN, c_block=4), 2, 10, 12, 8),
    ("lrn_pool_kblocks_g2", dict(groups=2, lrn=LRN, pool=POOL, k_block=4),
     2, 17, 24, 16),
    # the batched GEMM's tiling edges: T = 27 Winograd tiles (under one
    # 64-row tile), C = 5 (U padded to 16 channels with -0.0), K = 40
    # (under one 64-column tile) and K = 130 (three column tiles, scalar
    # stores of M), VALID 11 x 11 with the LRN over all 130 channels, and
    # Kb = 10 (4-byte copies of the slab)
    ("ragged_c5_k40_pool", dict(pool=POOL), 3, 11, 5, 40),
    ("ragged_k130", dict(), 1, 9, 5, 130),
    ("valid11_c5_k130_lrn", dict(padding="VALID", lrn=LRN), 2, 11, 5, 130),
    ("kb_not_x4_g2", dict(groups=2), 2, 9, 6, 20),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _inputs(seed, B, H, c_in, c_out, r, groups):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((r, r, c_in // groups, c_out))
         * (r * r * c_in / groups) ** -0.5).astype(np.float32)
    b = rng.standard_normal((c_out,)).astype(np.float32) * 0.1
    return x, w, b


def _both(fn, card, x, w, b):
    got = fn(*(torch.from_numpy(a).to(card) for a in (x, w, b)))
    torch.cuda.synchronize()
    ref = fn(*(torch.from_numpy(a) for a in (x, w, b)))
    return got.cpu().numpy(), ref.numpy()


def _close(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out", DIRECT_CASES)
def test_direct_kernel_matches_plain(card, name, kw, r, B, H, c_in, c_out):
    x, w, b = _inputs(0, B, H, c_in, c_out, r, kw.get("groups", 1))
    n0 = direct.launches
    got, ref = _both(lambda x, w, b: direct.conv2d_direct(
        x, w, b, relu=True, **kw), card, x, w, b)
    assert direct.launches == n0 + 1
    _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out", WINO_CASES)
def test_winograd_kernels_match_plain(card, name, kw, B, H, c_in, c_out):
    x, w, b = _inputs(1, B, H, c_in, c_out, 3, kw.get("groups", 1))
    before = ops.launch_counts()
    got, ref = _both(lambda x, w, b: winograd.conv2d_winograd(
        x, w, b, relu=True, **kw), card, x, w, b)
    key = ("conv_winograd_fused" if "lrn" in kw or "pool" in kw
           else "conv_winograd")
    assert ops.launch_counts()[key] == before[key] + 1
    _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out",
                         [c for c in WINO_CASES
                          if "lrn" in c[1] or "pool" in c[1]])
def test_fused_kernel_matches_plain_on_any_winograd_slab(card, name, kw, B,
                                                         H, c_in, c_out):
    """A Winograd-domain slab that is not G w G^T (``conv_bfp`` quantizes
    it) gives each pixel of a tile its own effective filter: the fused
    kernel must tile the map as the plain version does to agree."""
    x, w, b = _inputs(5, B, H, c_in, c_out, 3, kw.get("groups", 1))
    p = winograd.plan(x.shape, w.shape, **kw)
    slab = winograd.pack_weights(torch.from_numpy(w), p)
    slab = slab + 0.05 * torch.randn(
        slab.shape, generator=torch.Generator().manual_seed(0))
    got, ref = _both(lambda x, w, b: winograd.conv2d_winograd(
        x, w, b, slab.to(x.device), relu=True, **kw), card, x, w, b)
    _close(got, ref)


@pytest.mark.cuda
def test_nan_input_stays_visible(card):
    """A poisoned image must reach the logits screen as NaN: ReLU and the
    pool keep NaN on the kernel path, as they do in the plain version."""
    x, w, b = _inputs(2, 1, 35, 3, 16, 11, 1)
    x[0, 10, 10, 0] = np.nan
    got, ref = _both(lambda x, w, b: direct.conv2d_direct(
        x, w, b, stride=4, padding="VALID", relu=True, lrn=LRN, pool=POOL),
        card, x, w, b)
    assert np.array_equal(np.isnan(got), np.isnan(ref)) and np.isnan(got).any()


@pytest.mark.cuda
def test_nan_weight_on_a_padded_tap_stays_visible(card):
    """A NaN weight of tap (0, 0) meets only SAME padding at output pixel
    (0, 0): the kernel FMAs padded taps as zeros (0 * NaN = NaN) instead
    of skipping them, so its NaN pattern is the plain version's."""
    x, w, b = _inputs(6, 1, 9, 5, 8, 5, 1)
    w[0, 0, 2, 3] = np.nan
    got, ref = _both(lambda x, w, b: direct.conv2d_direct(
        x, w, b, relu=True), card, x, w, b)
    assert np.isnan(ref[0, 0, 0, 3]) and np.isnan(ref[..., 3]).all()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-4 * max(
        1.0, np.abs(ref[fin]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out", [
    ("conv5_full", dict(groups=2), 8, 13, 384, 256),
    ("pool2_g2", dict(groups=2), 2, 12, 20, 12)])
@pytest.mark.parametrize("pool", [POOL, (2, 2)])
def test_fused_pool_is_max_pool_of_the_conv_map(card, name, kw, B, H, c_in,
                                                c_out, pool):
    """With a pool and no LRN, kernel 3's output is F.max_pool2d of kernel
    2's conv map bit for bit: the same transforms and GEMM bits feed both,
    and a max rounds nothing."""
    x, w, b = (torch.from_numpy(a).to(card) for a in _inputs(
        7, B, H, c_in, c_out, 3, kw["groups"]))
    conv = winograd.conv2d_winograd(x, w, b, relu=True, **kw)
    pooled = winograd.conv2d_winograd(x, w, b, relu=True, pool=pool, **kw)
    torch.cuda.synchronize()
    want = torch.nn.functional.max_pool2d(conv.permute(0, 3, 1, 2), pool[0],
                                          pool[1]).permute(0, 2, 3, 1)
    assert torch.equal(pooled, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [None, POOL])
@pytest.mark.parametrize("where", ["input", "weight"])
def test_winograd_nan_stays_visible(card, where, pool):
    """A NaN input pixel poisons every output of the Winograd tiles that
    read it; a NaN weight of tap (0, 0), which meets only SAME padding at
    output pixel (0, 0), is spread by G w G^T over its channel's 36
    Winograd positions, and the kernels multiply padded inputs' zeros by
    it instead of skipping them.  Through ReLU and the pool, the NaN
    pattern is the plain version's."""
    x, w, b = _inputs(8, 2, 9, 5, 8, 3, 1)
    if where == "input":
        x[1, 5, 6, 3] = np.nan
    else:
        w[0, 0, 2, 3] = np.nan
    got, ref = _both(lambda x, w, b: winograd.conv2d_winograd(
        x, w, b, relu=True, pool=pool), card, x, w, b)
    if where == "input":
        assert np.isnan(ref[1]).any() and not np.isnan(ref[0]).any()
    else:
        assert np.isnan(ref[..., 3]).all() and not np.isnan(ref[..., 2]).any()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-4 * max(
        1.0, np.abs(ref[fin]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out",
                         [c for c in WINO_CASES if c[0].endswith("_full")])
def test_winograd_kernels_are_deterministic(card, name, kw, B, H, c_in,
                                            c_out):
    """Two calls on the same inputs give the same bits: every sum has one
    fixed order (no atomics, no split-K)."""
    x, w, b = (torch.from_numpy(a).to(card) for a in _inputs(
        10, B, H, c_in, c_out, 3, kw.get("groups", 1)))
    first = winograd.conv2d_winograd(x, w, b, relu=True, **kw)
    second = winograd.conv2d_winograd(x, w, b, relu=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["direct", "winograd", "winograd_fused"])
def test_kernel_blocking_is_bit_equal(card, kind):
    """The slab's channel and K blocking changes only addressing: each
    kernel sums the real channels in one fixed order, so any blocking
    gives the default's bits.  Both ``weight_prefetch`` values launch the
    same kernel (the direct kernel's cp.async ring stages its weights
    either way), so they give the same bits too."""
    if kind == "direct":
        x, w, b = _inputs(3, 2, 27, 96, 256, 5, 2)
        fn = direct.conv2d_direct
        kw = dict(groups=2, lrn=LRN, pool=POOL)
    else:
        x, w, b = _inputs(4, 2, 13, 384, 256, 3, 2)
        fn = winograd.conv2d_winograd
        kw = dict(groups=2, pool=POOL if kind == "winograd_fused" else None)
    x, w, b = (torch.from_numpy(a).to(card) for a in (x, w, b))
    base = fn(x, w, b, relu=True, **kw)
    other = fn(x, w, b, relu=True, c_block=40, k_block=32, **kw)
    no_prefetch = fn(x, w, b, relu=True, weight_prefetch=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(base, other)
    assert torch.equal(base, no_prefetch)


# ABFT: (kind, name, kw, r, B, H, c_in, c_out) at the five reduced AlexNet
# geometries and at full width, and slabs whose Kb is not a multiple of 4
# (4-byte copies)
ABFT_CASES = (
    [("direct",) + c for c in DIRECT_CASES[:4]]
    + [("direct", "g2_kb10_c3", dict(groups=2, lrn=LRN, pool=POOL), 3, 2, 9,
        6, 20)]
    + [("winograd", n, kw, 3, B, H, ci, co)
       for n, kw, B, H, ci, co in WINO_CASES[:6] + WINO_CASES[-1:]])


def _armed(kind, name, kw, r, B, H, c_in, c_out, seed=11, bfp=False):
    """(conv entry, x, w, b, armed slab, plan) on the CPU: the slab packed
    with its checksum rows (quantized and checksummed again under
    ``bfp``, as ``nn.conv.pack_conv_weights`` packs a ``conv_bfp`` slab)."""
    from repro_torch.core import bfp as core_bfp
    x, w, b = (torch.from_numpy(a) for a in _inputs(
        seed, B, H, c_in, c_out, r, kw.get("groups", 1)))
    mod = direct if kind == "direct" else winograd
    p = mod.plan(tuple(x.shape), tuple(w.shape), checksum=True, **{
        k: v for k, v in kw.items() if k != "lrn" or mod is winograd})
    slab = mod.pack_weights(w, p)
    if bfp:
        rows = core_bfp.quantize_dequantize(
            slab[..., :-1, :], block=np.gcd(p.Cb, 32), axis=-2)
        slab = dma.append_checksum_row(rows)
    fn = mod.conv2d_direct if kind == "direct" else mod.conv2d_winograd
    return fn, x, w, b, slab, p


def _flip_bits(slab, bits):
    flat = slab.clone().contiguous().view(-1).view(torch.uint8)
    for bit in bits:
        flat[bit // 8] ^= 1 << (bit % 8)
    return flat.view(slab.dtype).view(slab.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out", ABFT_CASES)
def test_armed_kernel_bit_equal_to_unarmed(card, kind, name, kw, r, B, H,
                                           c_in, c_out):
    """The armed instantiation reads the same Cb rows: its output is the
    unarmed kernel's bit for bit, with verdict 0 on a clean slab, and one
    launch a call."""
    fn, x, w, b, slab, p = _armed(kind, name, kw, r, B, H, c_in, c_out)
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    plain_slab = dma.pack_weight_tiles(
        dma.unpack_weight_tiles(slab, p.weights),
        dataclasses.replace(p.weights, checksum=False))
    base = fn(xc, wc, bc, plain_slab.to(card), relu=True, **kw)
    before = sum(ops.launch_counts().values())
    y, v = fn(xc, wc, bc, slab.to(card), relu=True, checksum=True, **kw)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == before + 1
    assert torch.equal(y, base) and int(v) == 0
    ref, v_ref = fn(x, w, b, slab, relu=True, checksum=True, **kw)
    assert int(v_ref) == 0
    _close(y.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bfp", [False, True], ids=["f32", "bfp"])
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out", ABFT_CASES)
def test_armed_verdict_equals_plain_for_seeded_flips(card, kind, name, kw, r,
                                                     B, H, c_in, c_out, bfp):
    """Seeded flips anywhere in the slab (single ones, each in a checksum
    row and in the last tile, and slabs of several flips): the kernel's
    verdict is the plain version's count, exactly, and above 0."""
    fn, x, w, b, slab, p = _armed(kind, name, kw, r, B, H, c_in, c_out,
                                  bfp=bfp)
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    nbits = slab.numel() * 32
    rng = np.random.default_rng(
        [[c[1] for c in ABFT_CASES].index(name), int(bfp)])
    row = 32 * p.Cb * p.Kb                  # tile 0's first checksum row
    flips = [[int(v)] for v in rng.integers(0, nbits, size=8)]
    flips += [[row + 7], [nbits - 1], [int(v) for v in rng.integers(
        0, nbits, size=5)]]
    for bits in flips:
        bad = _flip_bits(slab, bits)
        _, v = fn(xc, wc, bc, bad.to(card), relu=True, checksum=True, **kw)
        want = int(dma.checksum_mismatches(bad))
        assert int(v) == want > 0, (bits, int(v), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out",
                         [c for c in ABFT_CASES if c[1].endswith("_full")])
def test_armed_kernel_two_calls_bit_equal(card, kind, name, kw, r, B, H,
                                          c_in, c_out):
    """Two armed calls on a flipped slab: the same output bits and the
    same verdict (a block adds its count with one integer atomicAdd)."""
    fn, x, w, b, slab, _ = _armed(kind, name, kw, r, B, H, c_in, c_out)
    bad = _flip_bits(slab, [3, 32 * 1000 + 9, slab.numel() * 32 - 2])
    want = int(dma.checksum_mismatches(bad))
    xc, wc, bc, bad = x.to(card), w.to(card), b.to(card), bad.to(card)
    y1, v1 = fn(xc, wc, bc, bad, relu=True, checksum=True, **kw)
    y2, v2 = fn(xc, wc, bc, bad, relu=True, checksum=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and int(v1) == int(v2) == want == 3


# every block tile of kernels 1-3 against the default tile: the AlexNet
# layers (reduced and full width) and the edge geometries of both kernels
TILE_CASES = ([("direct",) + c for c in DIRECT_CASES]
              + [("winograd", n, kw, 3, B, H, ci, co)
                 for n, kw, B, H, ci, co in WINO_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize("slab_kind", ["f32", "bfp"])
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out", TILE_CASES)
def test_every_tile_bit_equal_to_the_default(card, kind, name, kw, r, B, H,
                                             c_in, c_out, slab_kind):
    """Each output is one thread's FMA chain in a fixed order, so every
    block tile the launcher is built for gives the default tile's bits,
    unarmed and armed (verdict 0 on a clean slab), on f32 slabs and on
    ``conv_bfp``-quantized ones; a tile the launcher is not built for on
    this slab raises and launches nothing."""
    fn, x, w, b, armed, p = _armed(kind, name, kw, r, B, H, c_in, c_out,
                                   seed=5, bfp=slab_kind == "bfp")
    plain = dma.pack_weight_tiles(
        dma.unpack_weight_tiles(armed, p.weights),
        dataclasses.replace(p.weights, checksum=False))
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    slab, armed = plain.to(card), armed.to(card)
    base = fn(xc, wc, bc, slab, relu=True, **kw).view(torch.int32)
    mod = direct if kind == "direct" else winograd
    for tile in mod.TILES:
        kwt = dict(kw, tile_rows=tile[0], tile_cols=tile[1])
        if tile not in mod.ANY_SLAB_TILES and p.Kb % 4:
            before = dict(ops.launch_counts())
            with pytest.raises(ValueError, match="16-byte"):
                fn(xc, wc, bc, slab, relu=True, **kwt)
            assert ops.launch_counts() == before
            continue
        y = fn(xc, wc, bc, slab, relu=True, **kwt)
        y_arm, v = fn(xc, wc, bc, armed, relu=True, checksum=True, **kwt)
        torch.cuda.synchronize()
        assert torch.equal(y.view(torch.int32), base), tile
        assert torch.equal(y_arm.view(torch.int32), base), tile
        assert int(v) == 0, tile


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["direct", "winograd"])
def test_launcher_refuses_a_tile_it_is_not_built_for(card, kind,
                                                     monkeypatch):
    """The C launcher checks the tile itself: a tile the Python side is
    told exists, but the launcher was not built for, fails the launch
    (``KernelError``) and never falls back to another tile."""
    mod = direct if kind == "direct" else winograd
    monkeypatch.setattr(mod, "TILES", mod.TILES + ((32, 32),))
    monkeypatch.setattr(mod, "ANY_SLAB_TILES",
                        mod.ANY_SLAB_TILES + ((32, 32),))
    r, kw = (5, dict(groups=2)) if kind == "direct" else (3, {})
    x, w, b = (torch.from_numpy(a).to(card) for a in _inputs(
        6, 2, 9, 8, 16, r, kw.get("groups", 1)))
    fn = mod.conv2d_direct if kind == "direct" else mod.conv2d_winograd
    before = dict(ops.launch_counts())
    with pytest.raises(build.KernelError, match="cudaError_t"):
        fn(x, w, b, relu=True, tile_rows=32, tile_cols=32, **kw)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_armed_forward_sums_layers_into_one_verdict(card):
    """The armed AlexNet forward on the card: one int32 verdict for the
    five layers, 0 when clean (logits bit-equal to unarmed), the flipped
    layer's count otherwise."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, sdc_abft=True)
    params = alexnet.init(0, cfg, device=card)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 67, 67, 3)).astype(np.float32)).to(card)
    packed = alexnet.pack_serving_slabs(params, cfg, 2)
    plain = alexnet.apply(params, dataclasses.replace(cfg, sdc_abft=False),
                          x)
    logits, sdc = alexnet.apply(params, cfg, x, packed=packed)
    assert torch.equal(logits, plain) and int(sdc) == 0
    bad = dict(packed)
    for name in ("conv2", "conv5"):
        pw = packed[name]
        bad[name] = dataclasses.replace(pw, data=_flip_bits(pw.data, [100]))
    _, sdc = alexnet.apply(params, cfg, x, packed=bad)
    assert int(sdc) == 2


class _FailingLib:
    """Stands in for the loaded kernel library: every launcher reports
    ``cudaErrorLaunchFailure`` (719)."""
    def __getattr__(self, name):
        return lambda *args: 719


@pytest.mark.cuda
def test_kernel_launch_error_raises_and_never_degrades(card, monkeypatch):
    """A kernel launch that fails on the card raises out of the engine; the
    bucket is not moved onto the ``direct`` route's library convolutions."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(), use_pallas=True)
    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=_FailingLib()))
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=2, degrade_threshold=1),
                    params=alexnet.init(0, cfg, device=card), device=card)
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.submit(ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)))
    with pytest.raises(build.KernelError, match="cudaError_t 719"):
        eng.run_until_done()
    s = eng.stats()
    assert s["degradations"] == [] and s["batches_failed"] == 0


@pytest.mark.cuda
def test_engine_builds_the_kernels_up_front(card, monkeypatch):
    """On the card, route ``pallas`` builds the kernels when the engine is
    made, so a kernel that cannot build fails there."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(), use_pallas=True)
    params = alexnet.init(0, cfg, device=card)

    def broken():
        raise build.KernelError("nvcc failed for ['conv_direct.cu']")

    monkeypatch.setattr(build, "library", broken)
    with pytest.raises(build.KernelError, match="nvcc failed"):
        CnnEngine(cfg, CnnServeConfig(), params=params, device=card)


# (K, N, block): fc6, fc8 and the reduced fc8 at their fc_block
BFP_SHAPES = [(9216, 4096, 32), (4096, 1000, 32), (48, 10, 16)]


def _bfp_inputs(seed, M, K, N, block):
    """ReLU-like activations with all-zero K-blocks (and, for M > 1, an
    all-zero row), and fan-in-scaled weights."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((M, K)), 0).astype(np.float32)
    x[:, block:2 * block] = 0.0
    if M > 1:
        x[M - 1] = 0.0
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,block", BFP_SHAPES)
@pytest.mark.parametrize("M", [1, 3, 8, 13])
def test_bfp_kernel_is_bit_equal_to_plain(card, M, K, N, block):
    x, w = _bfp_inputs(M + K, M, K, N, block)
    wq, we = bfp_ops.quantize_weights(torch.from_numpy(w).to(card),
                                      block=block)
    xc = torch.from_numpy(x).to(card)
    n0 = bfp_ops.launch_counts()["bfp_matmul"]
    got = bfp.bfp_matmul(xc, wq, we, block=block)
    torch.cuda.synchronize()
    assert bfp_ops.launch_counts()["bfp_matmul"] == n0 + 1
    plain = bfp.bfp_matmul_plain(xc, wq, we, block=block)
    assert bfp_ops.launch_counts()["bfp_matmul"] == n0 + 1
    assert torch.equal(got, plain)
    cpu = bfp.bfp_matmul(torch.from_numpy(x), wq.cpu(), we.cpu(),
                         block=block)
    assert torch.equal(got.cpu(), cpu)
    if M > 1:
        assert not got[M - 1].any()


@pytest.mark.cuda
def test_bfp_kernel_poisons_nonfinite_rows(card):
    x, w = _bfp_inputs(7, 4, 256, 64, 32)
    x[0, 3], x[2, 200] = np.nan, np.inf
    wq, we = bfp_ops.quantize_weights(torch.from_numpy(w).to(card), block=32)
    got = bfp.bfp_matmul(torch.from_numpy(x).to(card), wq, we, block=32)
    torch.cuda.synchronize()
    plain = bfp.bfp_matmul_plain(torch.from_numpy(x).to(card), wq, we,
                                 block=32)
    assert torch.isnan(got[0]).all() and torch.isnan(got[2]).all()
    assert torch.equal(got[1], plain[1]) and torch.equal(got[3], plain[3])


# (M, K, N, block): fc7, the LM fc_bfp head (smollm-360m: K 960, vocab
# 49,152) at a decode batch and at prefill-sized M, fc8 at M 64
BFP_SERVED_SHAPES = [(8, 4096, 4096, 32), (8, 960, 49152, 32),
                     (13, 960, 49152, 32), (64, 960, 49152, 32),
                     (64, 4096, 1000, 32), (13, 4096, 4096, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,block", BFP_SERVED_SHAPES)
def test_bfp_kernel_bit_equal_at_served_shapes(card, M, K, N, block):
    """Both column tiles (8 and 16 columns) and several 8-row tiles."""
    x, w = _bfp_inputs(M * 7 + N, M, K, N, block)
    wq, we = bfp_ops.quantize_weights(torch.from_numpy(w).to(card),
                                      block=block)
    xc = torch.from_numpy(x).to(card)
    got = bfp.bfp_matmul(xc, wq, we, block=block)
    torch.cuda.synchronize()
    assert torch.equal(got, bfp.bfp_matmul_plain(xc, wq, we, block=block))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,block", [(8, 9216, 4096, 32),
                                         (8, 4096, 1000, 32),
                                         (13, 4096, 4096, 32),
                                         (3, 48, 10, 16)])
@pytest.mark.parametrize("poison", [False, True])
def test_bfp_prepass_bytes_equal_quantize_activations(card, M, K, N, block,
                                                      poison):
    """The pre-pass's words and exponents in the scratch, byte for byte,
    all-zero blocks and rows included; with a NaN and an infinity, the
    bad-block exponent."""
    x, w = _bfp_inputs(M + K + N, M, K, N, block)
    if poison:
        x[0, 3], x[M - 1, K - 1] = np.nan, -np.inf
    wq, we = bfp_ops.quantize_weights(torch.from_numpy(w).to(card),
                                      block=block)
    xc = torch.from_numpy(x).to(card)
    _, scratch = bfp._bfp_matmul_cuda(xc, wq, we, block=block)
    torch.cuda.synchronize()
    words, exps = bfp.quantize_activations(xc, block)
    assert torch.equal(scratch[:words.numel()].view(words.shape), words)
    assert torch.equal(scratch[words.numel():].view(exps.shape), exps)
    if poison:
        assert exps[0, 0, 0] == bfp.BAD_EXPONENT


class _FailingBfp:
    """The loaded kernel library with only the BFP matmul launcher
    reporting ``cudaErrorLaunchFailure`` (719)."""
    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        if name == "repro_bfp_matmul":
            return lambda *args: 719
        return getattr(self._real, name)


@pytest.mark.cuda
def test_bfp_launch_error_raises_out_of_the_engine(card, monkeypatch):
    """With fc_bfp and conv_bfp, a failed BFP matmul launch raises
    ``KernelError`` out of the engine after the conv kernels ran; nothing
    degrades."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, fc_bfp=True, conv_bfp=True)
    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=_FailingBfp(real.lib)))
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=2, degrade_threshold=1),
                    params=alexnet.init(0, cfg, device=card), device=card)
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.submit(ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)))
    before = ops.launch_counts()["conv_direct"]
    with pytest.raises(build.KernelError, match="bfp_matmul.*719"):
        eng.run_until_done()
    assert ops.launch_counts()["conv_direct"] == before + 2
    s = eng.stats()
    assert s["degradations"] == [] and s["batches_failed"] == 0


# kernel 5 -------------------------------------------------------------------
# (atol, rtol) against the plain version with f32 probabilities
DECODE_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 1e-2)}
# rtol = atol against the plain version the models call
DECODE_TOL_MODELS = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _decode_inputs(seed, B, S, H, KV, D, dtype, card):
    """q, caches and ragged lengths in [1, S] that include S and 1."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype)
        for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    lens = rng.integers(1, S + 1, B)
    lens[0], lens[-1] = S, 1
    return q, k, v, torch.from_numpy(lens.astype(np.int32)).to(card)


def _decode_close(got, ref, dtype, tol=None):
    atol, rtol = DECODE_TOL[dtype] if tol is None else (tol, tol)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("S", [77, 512])
def test_decode_attn_kernel_matches_plain(card, dtype, D, G, S):
    """Ragged lengths including S itself; S = 77 is no multiple of the rows
    a block reads per step."""
    q, k, v, lens = _decode_inputs(D + G + S, 4, S, 2 * G, 2, D, dtype,
                                   card)
    n0 = decode_attn.launches
    got = decode_attn.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attn.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _decode_close(got, decode_attention_f32_ref(q, k, v, lens), dtype)
    _decode_close(got, decode_attn.decode_attention_ref(q, k, v, lens),
                  dtype, DECODE_TOL_MODELS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [(3, 64, 4, 2, 16), (2, 100, 8, 8, 32),
                                        (1, 33, 6, 3, 8), (2, 33, 6, 3, 8),
                                        (2, 40, 12, 2, 64),
                                        (8, 512, 15, 5, 64),
                                        (2, 2048, 24, 8, 128),
                                        (8, 512, 32, 8, 128)])
def test_decode_attn_kernel_geometries(card, dtype, B, S, H, KV, D):
    """The JAX package's sweep, a group of 6 (two blocks of query heads per
    KV head), and the smollm-360m, llama3.2-3b and jamba-v0.1-52b (G = 4)
    decode geometries."""
    q, k, v, lens = _decode_inputs(B * S, B, S, H, KV, D, dtype, card)
    got = dec_ops.decode_attention(q, k, v, lens)
    _decode_close(got, decode_attention_f32_ref(q, k, v, lens), dtype)
    _decode_close(got, decode_attention_f32_ref(
        q.cpu(), k.cpu(), v.cpu(), lens.cpu()), dtype)
    _decode_close(got, dec_ops.decode_attention(q, k, v, lens, pallas=False),
                  dtype, DECODE_TOL_MODELS[dtype])
    _decode_close(got, dec_ops.decode_attention(
        q.cpu(), k.cpu(), v.cpu(), lens.cpu()), dtype,
        DECODE_TOL_MODELS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_length_zero_and_scalar(card, dtype):
    """Length 0 attends uniformly (the mean of v over S), as the reference
    does; a scalar length broadcasts to every slot."""
    q, k, v, _ = _decode_inputs(5, 3, 50, 6, 2, 64, dtype, card)
    lens = torch.tensor([0, 7, 50], dtype=torch.int32, device=card)
    got = dec_ops.decode_attention(q, k, v, lens)
    _decode_close(got, decode_attention_f32_ref(q, k, v, lens), dtype)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(3, dim=0)
    _decode_close(got[0, 0], mean_v, dtype)
    _decode_close(dec_ops.decode_attention(q, k, v, 9),
                  decode_attention_f32_ref(q, k, v, 9), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [(4, 64, 4, 2, 16),
                                        (8, 2048, 15, 5, 64),
                                        (8, 2048, 24, 8, 128)])
def test_decode_attn_lse_mode(card, dtype, B, S, H, KV, D):
    """The lse mode (one rank's block of a cache split along rows): the
    output bit-equal to the mode without lse where a slot has rows, 0
    where it has none; the lse within 1e-4 (1 + |lse|) of the plain
    version's, -inf where it has none; one launch."""
    q, k, v, lens = _decode_inputs(B + S + D, B, S, H, KV, D, dtype, card)
    lens[1] = 0
    lens[-1] = -5
    n0 = decode_attn.launches
    got, lse = decode_attn.decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attn.launches == n0 + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    full = lens > 0
    plain = decode_attn.decode_attention(q, k, v, lens)
    assert torch.equal(got[full].view(torch.int8),
                       plain[full].view(torch.int8))
    assert (got[~full] == 0).all() and torch.isneginf(lse[~full]).all()
    ref, ref_lse = decode_attention_f32_ref(q, k, v, lens, return_lse=True)
    _decode_close(got, ref, dtype)
    assert torch.isfinite(lse[full]).all()
    assert ((lse[full] - ref_lse[full]).abs()
            <= 1e-4 * (1 + ref_lse[full].abs())).all()


def _decode_check(q, k, v, lens, dtype):
    got = decode_attn.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    _decode_close(got, decode_attention_f32_ref(q, k, v, lens), dtype)
    _decode_close(got, decode_attn.decode_attention_ref(q, k, v, lens),
                  dtype, DECODE_TOL_MODELS[dtype])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_skewed_lengths(card, dtype):
    """llama3.2-3b's geometry with one slot at S and the rest at 1: the
    long slot spans every split."""
    q, k, v, _ = _decode_inputs(11, 8, 2048, 24, 8, 128, dtype, card)
    lens = torch.tensor([2048] + [1] * 7, dtype=torch.int32, device=card)
    _decode_check(q, k, v, lens, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [(8, 512, 15, 5, 64),
                                        (8, 2048, 24, 8, 128)])
def test_decode_attn_lengths_around_split_boundaries(card, dtype, B, S, H,
                                                     KV, D):
    """Lengths R - 1, R, R + 1, 2R - 1, 2R, 2R + 1, S and 0 at the served
    geometries' own R."""
    R = decode_attn.split_rows(B, S, KV, H // KV, D)
    assert R < S
    q, k, v, _ = _decode_inputs(R + D, B, S, H, KV, D, dtype, card)
    lens = torch.tensor([R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, S,
                         0][:B], dtype=torch.int32, device=card)
    _decode_check(q, k, v, lens, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_s_not_a_multiple_of_the_split(card, dtype):
    """S = 300 over R = 32-row splits (a ragged last split), lengths S,
    299, 33 and 1."""
    B, S, H, KV, D = 4, 300, 6, 2, 64
    R = decode_attn.split_rows(B, S, KV, H // KV, D)
    assert S % R and R < S
    q, k, v, _ = _decode_inputs(7, B, S, H, KV, D, dtype, card)
    lens = torch.tensor([S, S - 1, 33, 1], dtype=torch.int32, device=card)
    _decode_check(q, k, v, lens, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_long_cache_widens_the_split(card, dtype):
    """S = 40,000: past 128 splits of 256 rows the split widens to 512
    rows, and the merge still takes every split of a slot."""
    B, S, H, KV, D = 2, 40000, 6, 2, 64
    R = decode_attn.split_rows(B, S, KV, H // KV, D)
    assert R > decode_attn.MAX_SPLIT_ROWS
    q, k, v, _ = _decode_inputs(17, B, S, H, KV, D, dtype, card)
    lens = torch.tensor([S, 33333], dtype=torch.int32, device=card)
    _decode_check(q, k, v, lens, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_length_zero_beside_long_slots(card, dtype):
    """A slot of length 0 (the mean of v over all S rows, every split)
    between full-length slots."""
    q, k, v, _ = _decode_inputs(13, 4, 1024, 24, 8, 128, dtype, card)
    lens = torch.tensor([1024, 0, 1000, 0], dtype=torch.int32, device=card)
    got = _decode_check(q, k, v, lens, dtype)
    mean_v = v[1].float().mean(dim=0).repeat_interleave(3, dim=0)
    _decode_close(got[1, 0], mean_v, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", [(8, 512, 15, 5, 64),
                                        (8, 2048, 24, 8, 128)])
def test_decode_attn_two_calls_are_bit_equal(card, B, S, H, KV, D):
    """The splits merge in a fixed order whatever block arrives last (an
    integer ticket, no float atomics): equal bits; and every merge sets its
    ticket back to 0."""
    q, k, v, lens = _decode_inputs(B + S, B, S, H, KV, D, torch.bfloat16,
                                   card)
    a = decode_attn.decode_attention(q, k, v, lens)
    b = decode_attn.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert all(not t.any() for t in decode_attn._TICKETS.values())


@pytest.mark.cuda
def test_decode_attn_launch_error_raises(card, monkeypatch):
    class Failing:
        def __init__(self, real):
            self._real = real

        def __getattr__(self, name):
            if name == "repro_decode_attn":
                return lambda *args: 719
            return getattr(self._real, name)

    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=Failing(real.lib)))
    q, k, v, lens = _decode_inputs(0, 2, 16, 4, 2, 16, torch.float32, card)
    with pytest.raises(build.KernelError, match="decode_attn.*719"):
        decode_attn.decode_attention(q, k, v, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "llama3.2-3b",
                                  "granite-moe-1b-a400m"])
def test_engine_decodes_through_kernel5(card, arch):
    """The reduced model served on the card launches kernel 5 once per
    layer per decode step and emits the CPU engine's greedy tokens."""
    cfg = get_config(arch).reduced()
    params = lm.init(0, cfg, device="cpu")
    scfg = ServeConfig(max_batch=3, max_len=64, prefill_bucket=16)
    out = {}
    for dev in ("cpu", card):
        eng = Engine(cfg, scfg, params=lm.to_device(params, dev), device=dev)
        reqs = [Request(prompt=list(range(1, n + 1)), max_new=5)
                for n in (5, 12, 3, 20)]
        for r in reqs:
            eng.submit(r)
        n0 = decode_attn.launches
        eng.run_until_done()
        out[str(dev)] = [r.generated for r in reqs]
        if dev == card:
            assert decode_attn.launches - n0 == \
                cfg.num_layers * eng.decode_steps
    assert out["cpu"] == out[str(card)]


# kernels 6 and 7 ------------------------------------------------------------
BF16_STEP = 2.0 ** -7


def _f32_close(got, ref, dtype, rel_step=False):
    """max|diff| <= 1e-5 * max|ref|, plus one bf16 step of |ref| where the
    output was rounded to bf16 (``rel_step``)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape
    bound = 1e-5 * float(ref.abs().max())
    if rel_step and dtype == torch.bfloat16:
        bound = bound + BF16_STEP * ref.abs()
    excess = float(((got - ref).abs() - bound).max())
    assert excess <= 0, excess


def _ssd_card_inputs(seed, B, L, H, P, G, N, dtype, card):
    """The model's ranges: dt after softplus in [1e-3, 1e-1], A in
    [-16, -1] (mamba's init), so the prefix sums reach the -60 clip."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(card, dt)
    return (t(rng.standard_normal((B, L, H, P))),
            t(rng.uniform(1e-3, 1e-1, (B, L, H)), torch.float32),
            t(-rng.uniform(1.0, 16.0, (H,)), torch.float32),
            t(rng.standard_normal((B, L, G, N))),
            t(rng.standard_normal((B, L, G, N))))


# (B, L, H, P, G, N, chunk): mamba2-2.7b's served geometry (one ragged
# chunk of 200) and three chunks with a ragged tail; groups > 1; L = 1;
# N = 256 (the kernel's largest); the JAX package's sweep; jamba-v0.1-52b's
# heads (N = 16, under every state slice) at a served and a long prompt
SSD_CARD_CASES = [(1, 200, 80, 64, 1, 128, 256), (1, 600, 8, 64, 1, 128, 256),
                  (2, 100, 4, 8, 2, 16, 32), (2, 37, 6, 16, 3, 32, 16),
                  (1, 1, 4, 64, 1, 128, 256), (2, 300, 4, 64, 2, 256, 128),
                  (2, 64, 4, 8, 2, 16, 16), (2, 16, 8, 16, 1, 4, 16),
                  (1, 200, 128, 64, 1, 16, 256),
                  (1, 2048, 128, 64, 1, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CARD_CASES)
def test_ssd_kernel_matches_plain(card, dtype, B, L, H, P, G, N, chunk):
    args = _ssd_card_inputs(L + N, B, L, H, P, G, N, dtype, card)
    n0 = ssd.launches
    y, st = ssd_ops.ssd_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == n0 + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    y_ref, st_ref = ssd.ssd_chunked_plain(*args, chunk=chunk)
    _f32_close(y, y_ref, dtype, rel_step=True)
    _f32_close(st, st_ref, dtype)
    # the plain version on the CPU too
    y_cpu, st_cpu = ssd_ops.ssd_chunked(*(a.cpu() for a in args),
                                        chunk=chunk)
    _f32_close(y, y_cpu, dtype, rel_step=True)
    _f32_close(st, st_cpu, dtype)


@pytest.mark.cuda
def test_ssd_kernel_is_deterministic_and_padding_free(card):
    """Two runs are bit-equal; rows past L (here a second call on the
    same rows padded with zeros and dt = 0) leave the state unchanged."""
    x, dt, A, Bm, Cm = _ssd_card_inputs(3, 1, 300, 8, 64, 1, 128,
                                        torch.bfloat16, card)
    y1, s1 = ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=128)
    y2, s2 = ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=128)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    pad = [torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, 84))
           for t in (x, dt, Bm, Cm)]
    y3, s3 = ssd.ssd_chunked_pallas(pad[0], pad[1], A, pad[2], pad[3],
                                    chunk=128)
    assert torch.equal(s3, s1) and torch.equal(y3[:, :300], y1)


# mamba2-2.7b's heads at L = 256 k - 1, 256 k and 256 k + 1 (k = 1, 2, 8):
# one chunk or several, ragged last chunks, a last chunk of one row
SSD_BOUNDARY_LENGTHS = [255, 256, 257, 511, 512, 513, 2047, 2048, 2049]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", SSD_BOUNDARY_LENGTHS)
def test_ssd_kernel_at_chunk_boundaries(card, dtype, L):
    """The chunk count, the ragged tail and the state pass at the served
    width: within the gate of the plain version, two calls bit-equal."""
    args = _ssd_card_inputs(L, 1, L, 80, 64, 1, 128, dtype, card)
    y, st = ssd.ssd_chunked_pallas(*args, chunk=256)
    y2, st2 = ssd.ssd_chunked_pallas(*args, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y_ref, st_ref = ssd.ssd_chunked_plain(*args, chunk=256)
    _f32_close(y, y_ref, dtype, rel_step=True)
    _f32_close(st, st_ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_decays_reach_the_clip(card, dtype):
    """dt in [0.5, 1] and A = -16: every chunk's cums passes -60 within
    eight rows, so most exponents are clipped; the kernel stays within the
    gate of the plain version, and two calls are bit-equal."""
    B, L, H, P, G, N = 1, 300, 8, 64, 1, 128
    x, _, _, Bm, Cm = _ssd_card_inputs(7, B, L, H, P, G, N, dtype, card)
    rng = np.random.default_rng(8)
    dt = torch.from_numpy(rng.uniform(0.5, 1.0, (B, L, H)).astype(
        np.float32)).to(card)
    A = torch.full((H,), -16.0, device=card)
    assert float((dt[:, :8] * A).sum(1).max()) < -60.0
    y, st = ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=256)
    y2, st2 = ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y_ref, st_ref = ssd.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=256)
    _f32_close(y, y_ref, dtype, rel_step=True)
    _f32_close(st, st_ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [200, 2048])
def test_ssd_kernel_masks_state_rows_past_n(card, monkeypatch, L):
    """jamba-v0.1-52b's heads (H = 128, N = 16): every row tile and state
    slice (32 or 64 state rows a block, more than N) gives the same bits,
    within the gate of the plain version, and a NaN stored just past B
    and C (where an unmasked state row would read) stays out of y and the
    state."""
    H, N = 128, 16
    args = list(_ssd_card_inputs(L + 5, 1, L, H, 64, 1, N, torch.bfloat16,
                                 card))
    for i in (3, 4):        # B and C, each followed by NaNs in memory
        t = args[i]
        buf = torch.full((t.numel() + 4096,), float("nan"), dtype=t.dtype,
                         device=card)
        buf[:t.numel()] = t.reshape(-1)
        args[i] = buf[:t.numel()].view(t.shape)
    ref = ssd.ssd_chunked_pallas(*args, chunk=256)
    assert all(bool(torch.isfinite(r).all()) for r in ref)
    y_ref, st_ref = ssd.ssd_chunked_plain(*args, chunk=256)
    _f32_close(ref[0], y_ref, torch.bfloat16, rel_step=True)
    _f32_close(ref[1], st_ref, torch.bfloat16)
    one_chunk = L <= 256
    for rt in ssd.ROW_TILES:
        for ns in ((rt,) if one_chunk else ssd.STATE_SLICES):
            assert ns > N
            monkeypatch.setattr(ssd, "row_tile", lambda *a, rt=rt: rt)
            monkeypatch.setattr(ssd, "state_slice", lambda *a, ns=ns: ns)
            y, st = ssd.ssd_chunked_pallas(*args, chunk=256)
            torch.cuda.synchronize()
            assert torch.equal(y, ref[0]) and torch.equal(st, ref[1]), \
                (rt, ns)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [200, 472])
def test_ssd_kernel_bit_equal_across_tiles(card, monkeypatch, L):
    """Every row tile and state slice the kernel takes gives the same bits
    (each output's sums are one order whatever the blocking)."""
    args = _ssd_card_inputs(L + 1, 1, L, 80, 64, 1, 128, torch.bfloat16,
                            card)
    ref = ssd.ssd_chunked_pallas(*args, chunk=256)
    one_chunk = L <= 256
    for rt in ssd.ROW_TILES:
        for ns in ((rt,) if one_chunk else ssd.STATE_SLICES):
            monkeypatch.setattr(ssd, "row_tile", lambda *a, rt=rt: rt)
            monkeypatch.setattr(ssd, "state_slice", lambda *a, ns=ns: ns)
            y, st = ssd.ssd_chunked_pallas(*args, chunk=256)
            torch.cuda.synchronize()
            assert torch.equal(y, ref[0]) and torch.equal(st, ref[1]), \
                (rt, ns)


DW1D_CARD_CASES = [(1, 200, 5120), (1, 2048, 5120), (2, 7, 128), (2, 33, 5),
                   (3, 100, 96), (1, 1, 8), (1, 2, 130), (2, 64, 8),
                   (1, 200, 8192), (1, 2048, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", DW1D_CARD_CASES)
def test_dw1d_kernel_matches_plain(card, dtype, B, L, C):
    """mamba2-2.7b's x stream (C = d_inner = 5120) at the served and a
    long prompt length, L not a multiple of 3, C not a multiple of a
    block, with and without bias."""
    rng = np.random.default_rng(L + C)
    x = torch.from_numpy(rng.standard_normal((B, L, C)).astype(
        np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.standard_normal((4, C)) * 0.5).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((C,)).astype(np.float32)).to(
        card)
    for bias in (b, None):
        n0 = winograd.dw1d_launches
        got = ops.conv1d_depthwise_causal(x, w, bias)
        torch.cuda.synchronize()
        assert winograd.dw1d_launches == n0 + 1
        assert got.dtype == dtype and got.shape == x.shape
        bb = torch.zeros_like(w[0]) if bias is None else bias
        _f32_close(got, winograd.conv1d_depthwise_causal_plain(x, w, bb),
                   dtype, rel_step=True)
        _f32_close(got, ops.conv1d_depthwise_causal(
            x.cpu(), w.cpu(), None if bias is None else bias.cpu()), dtype,
            rel_step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", DW1D_CARD_CASES)
def test_dw1d_kernel_bit_equal_across_launch_settings(card, monkeypatch,
                                                      dtype, B, L, C):
    """Every tiles-a-block in {1, 2, 4} gives the rule's bits: each
    output's fmaf chains are one."""
    rng = np.random.default_rng(L * C)
    x = torch.from_numpy(rng.standard_normal((B, L, C)).astype(
        np.float32)).to(card, dtype)
    w = torch.from_numpy(rng.standard_normal((4, C)).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((C,)).astype(np.float32)).to(
        card)
    ref = winograd.conv1d_depthwise_causal(x, w, b)
    for t in winograd.DW1D_TILES:
        monkeypatch.setattr(winograd, "dw1d_launch", lambda *a, t=t: t)
        got = winograd.conv1d_depthwise_causal(x, w, b)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), t


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["ssd", "dw1d"])
def test_ssd_and_dw1d_launch_errors_raise(card, monkeypatch, which):
    class Failing:
        def __init__(self, real):
            self._real = real

        def __getattr__(self, name):
            if name == f"repro_{which}":
                return lambda *args: 719
            return getattr(self._real, name)

    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=Failing(real.lib)))
    if which == "ssd":
        args = _ssd_card_inputs(0, 1, 20, 2, 8, 1, 16, torch.float32, card)
        call = lambda: ssd.ssd_chunked_pallas(*args)  # noqa: E731
    else:
        x = torch.ones((1, 9, 4), device=card)
        call = lambda: winograd.conv1d_depthwise_causal(  # noqa: E731
            x, torch.ones((4, 4), device=card))
    with pytest.raises(build.KernelError, match=f"{which}.*719"):
        call()


# kernel 7's backward: mamba2-2.7b's training shapes beside the cases above
DW1D_BWD_CASES = DW1D_CARD_CASES + [(1, 512, 5120), (2, 257, 5120)]


def _dw1d_bwd_inputs(seed, B, L, C, dtype, card):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(card, dt)
    return (t(rng.standard_normal((B, L, C))),
            t(rng.standard_normal((B, L, C))),
            t(rng.standard_normal((4, C)) * 0.5, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", DW1D_BWD_CASES)
def test_dw1d_dx_bit_equal_to_flipped_forward(card, monkeypatch, dtype, B,
                                              L, C):
    """dx is kernel 7 time-reversed: bit-equal to flip(kernel7(flip(dy)))
    with a zero bias at every tiles-a-block the launcher is built for, and
    within one bf16 step of the plain version (the reference's formula)."""
    _, dy, w = _dw1d_bwd_inputs(L + C, B, L, C, dtype, card)
    zero = torch.zeros((C,), device=card)
    plain = winograd.conv1d_depthwise_causal_dx_plain(dy, w)
    for t in winograd.DW1D_TILES:
        monkeypatch.setattr(winograd, "dw1d_launch", lambda *a, t=t: t)
        n0, f0 = winograd.dw1d_bwd_launches, winograd.dw1d_launches
        dx = winograd.conv1d_depthwise_causal_dx(dy, w)
        ref = winograd.conv1d_depthwise_causal(
            dy.flip(1).contiguous(), w, zero).flip(1)
        torch.cuda.synchronize()
        assert winograd.dw1d_bwd_launches == n0 + 1
        assert winograd.dw1d_launches == f0 + 1
        assert dx.dtype == dtype and torch.equal(dx, ref), t
        _f32_close(dx, plain, dtype, rel_step=True)


def _wgrad_close(got, ref, dtype, rel_step):
    """max|diff| <= 1e-4 * max|ref| (f32 sums of up to B * L terms in
    other orders), plus one bf16 step of |ref| where ``rel_step`` (db is
    rounded to dy's dtype)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape and got.dtype == torch.float32
    bound = 1e-4 * float(ref.abs().max())
    if rel_step and dtype == torch.bfloat16:
        bound = bound + BF16_STEP * ref.abs()
    excess = float(((got - ref).abs() - bound).max())
    assert excess <= 0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", DW1D_BWD_CASES)
def test_dw1d_wgrad_matches_plain_and_repeats(card, dtype, B, L, C):
    """dw and db against the reference's formula (f32 einsum, db summed in
    dy's dtype); a second run gives the same bits (no atomics)."""
    x, dy, _ = _dw1d_bwd_inputs(L * 7 + C, B, L, C, dtype, card)
    n0 = winograd.dw1d_wgrad_launches
    dw, db = winograd.conv1d_depthwise_causal_wgrad(x, dy, 4)
    dw2, db2 = winograd.conv1d_depthwise_causal_wgrad(x, dy, 4)
    torch.cuda.synchronize()
    assert winograd.dw1d_wgrad_launches == n0 + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    pdw, pdb = winograd.conv1d_depthwise_causal_wgrad_plain(x, dy, 4)
    _wgrad_close(dw, pdw, dtype, rel_step=False)
    _wgrad_close(db, pdb, dtype, rel_step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw1d_entry_gradients_card_vs_cpu(card, dtype):
    """The autograd entry on the card (kernel 7 forward, dx, wgrad) against
    the same entry on the CPU (the plain versions), with a bias."""
    x, dy, w = _dw1d_bwd_inputs(3, 2, 77, 300, dtype, card)
    b = torch.linspace(-1, 1, 300, device=card)
    grads = {}
    for dev in (card, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (x, w, b)]
        y = ops.conv1d_depthwise_causal(*leaves)
        y.backward(dy.to(dev))
        grads[dev.type] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for got, ref, rel in zip(grads["cuda"], grads["cpu"],
                             (True, False, True)):
        assert got.dtype == ref.dtype
        _wgrad_close(got, ref, dtype, rel_step=rel)


@pytest.mark.cuda
def test_dw1d_wgrad_launch_error_raises(card, monkeypatch):
    class Failing:
        def __init__(self, real):
            self._real = real

        def __getattr__(self, name):
            if name == "repro_dw1d_wgrad":
                return lambda *args: 719
            return getattr(self._real, name)

    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=Failing(real.lib)))
    x = torch.ones((1, 9, 4), device=card)
    with pytest.raises(build.KernelError, match="dw1d_wgrad.*719"):
        winograd.conv1d_depthwise_causal_wgrad(x, x, 4)


@pytest.mark.cuda
def test_engine_prefills_mamba_through_kernels_6_and_7(card):
    """The reduced mamba2-2.7b served on the card launches kernels 6 and 7
    once per layer per prefill and emits the CPU engine's greedy tokens;
    prompts of 1-2 tokens (shorter than the conv window) and one over two
    chunks included."""
    cfg = get_config("mamba2-2.7b").reduced()
    params = lm.init(0, cfg, device="cpu")
    scfg = ServeConfig(max_batch=3, max_len=64)
    prompts = [list(range(1, n + 1)) for n in (5, 1, 20, 2, 9)]
    out = {}
    for dev in ("cpu", card):
        eng = Engine(cfg, scfg, params=lm.to_device(params, dev), device=dev)
        reqs = [Request(prompt=p, max_new=5) for p in prompts]
        for r in reqs:
            eng.submit(r)
        n6, n7 = ssd.launches, winograd.dw1d_launches
        eng.run_until_done()
        out[str(dev)] = [r.generated for r in reqs]
        if dev == card:
            assert ssd.launches - n6 == cfg.num_layers * len(prompts)
            assert winograd.dw1d_launches - n7 == \
                cfg.num_layers * len(prompts)
    assert out["cpu"] == out[str(card)]


# ---------------------------------------------------------------------------
# kernels 1-3 in bf16, and at VGG-16's geometries
# ---------------------------------------------------------------------------
# bf16 rule (kernels 2-3, and kernel 1 on an f32 slab): kernel(x, slab, b)
# on bf16 x and bias is bit-equal to the same kernel on the widened inputs
# with its output rounded to bf16, at every block tile, armed and unarmed;
# within one bf16 step (rtol 2**-7, atol 1e-5 * max|plain|) of the plain
# version on the same inputs.  Kernel 1 on a bf16 slab runs on the tensor
# cores, whose f32 sums differ from the FFMA chain's by f32 noise, so it
# follows rule (a)-(d) instead (``_mma_rule``)
BF16_CASES = [c for c in TILE_CASES if c[1] in (
    "conv1_reduced", "conv2_reduced", "conv1_full", "conv2_full",
    "g2_c4_lrn_pool", "lrn_k130_epilogue", "conv3_reduced", "conv5_reduced",
    "conv3_full", "conv4_full", "conv5_full", "ragged_c5_k40_pool",
    "kb_not_x4_g2")]
# VGG-16's conv geometries, each (H, C_in, C_out, pooled) once: 2x2/2 pools
# closing the stages, C_in = 3 on a Winograd layer, 224-pixel planes
VGG_CASES = [(224, 3, 64, False), (224, 64, 64, True), (112, 64, 128, False),
             (112, 128, 128, True), (56, 128, 256, False),
             (56, 256, 256, False), (56, 256, 256, True),
             (28, 256, 512, False), (28, 512, 512, False),
             (28, 512, 512, True), (14, 512, 512, False),
             (14, 512, 512, True)]
VGG_IDS = [f"{h}_{c}_{k}{'_pool' if p else ''}" for h, c, k, p in VGG_CASES]


def _bf16_layer(kind, kw, r, B, H, c_in, c_out, seed, armed):
    """(entry, x, w, b, slab) in bf16 on the CPU, the slab in the dtype
    the reference packs (direct bf16, Winograd f32)."""
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(
        seed, B, H, c_in, c_out, r, kw.get("groups", 1)))
    mod = direct if kind == "direct" else winograd
    p = mod.plan(tuple(x.shape), tuple(w.shape), checksum=armed, **{
        k: v for k, v in kw.items() if k != "lrn" or mod is winograd})
    slab = mod.pack_weights(w, p)
    fn = mod.conv2d_direct if kind == "direct" else mod.conv2d_winograd
    return fn, x, w, b, slab


def _within_one_step(got, ref):
    """max(|got - ref| - (one bf16 step of |ref| + 1e-5 max|ref|)): <= 0
    within one bf16 step."""
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    return float((np.abs(got - ref) - (2.0 ** -7 * np.abs(ref)
                                       + 1e-5 * np.abs(ref).max())).max())


def _steps_apart(got, want):
    """max(|got - want| - (one bf16 step at the larger magnitude + 1e-5
    max|want|)) over the finite outputs: <= 0 when no output is more than
    one bf16 step from the other (the floor lets a ReLU output near zero
    round from f32 noise)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    fin = np.isfinite(got) & np.isfinite(want)
    g, w = got[fin].astype(np.float64), want[fin].astype(np.float64)
    mag = np.maximum(np.abs(g), np.abs(w))
    _, e = np.frexp(np.where(mag > 0, mag, 1.0))
    step = np.where(mag > 0, np.ldexp(1.0, e - 8), 0.0)
    return float((np.abs(g - w) - step
                  - 1e-5 * np.abs(w).max(initial=0.0)).max(initial=-1.0))


def _mma_rule(fn, x, w, b, slab, armed_slab, plain, kw, tiles):
    """Kernel 1's bf16-slab route, rule (a)-(d) at every tile of
    ``tiles``: (a) within one bf16 step of the plain version; (b) every
    tile, the armed call and a second call bit-equal to the default
    tile, the armed verdict 0 on a clean slab; (c) no output more than
    one bf16 step from the f32 kernel on the widened inputs, rounded; (d)
    non-finite wherever that one is.  Returns the share of outputs that
    differ from it."""
    base = fn(x, w, b, slab, relu=True, **kw)
    want = fn(x.float(), w.float(), b.float(), slab.float(), relu=True,
              **kw).to(torch.bfloat16)
    for tile in tiles:
        kwt = dict(kw, tile_rows=tile[0], tile_cols=tile[1])
        y = fn(x, w, b, slab, relu=True, **kwt)
        y_arm, v = fn(x, w, b, armed_slab, relu=True, checksum=True, **kwt)
        torch.cuda.synchronize()
        assert y.dtype is torch.bfloat16
        for got in (y, y_arm):
            assert torch.equal(got.view(torch.int16),
                               base.view(torch.int16)), tile
        assert int(v) == 0, tile
    assert _within_one_step(base, plain) <= 0
    assert _steps_apart(base, want) <= 0
    assert bool((~torch.isfinite(base) >= ~torch.isfinite(want)).all())
    return float((base.float() != want.float()).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out", BF16_CASES)
def test_bf16_kernels_follow_the_rule_at_every_tile(card, kind, name, kw, r,
                                                    B, H, c_in, c_out):
    mod = direct if kind == "direct" else winograd
    if kind == "direct":
        fn, x, w, b, slab = _bf16_layer(kind, kw, r, B, H, c_in, c_out, 7,
                                        False)
        armed = _bf16_layer(kind, kw, r, B, H, c_in, c_out, 7, True)[4]
        assert slab.dtype is armed.dtype is torch.bfloat16
        plain = fn(x, w, b, slab, relu=True, **kw)
        xc, wc, bc, sc, ac = (t.to(card) for t in (x, w, b, slab, armed))
        _mma_rule(fn, xc, wc, bc, sc, ac, plain, kw, direct.MMA_TILES)
        return
    for armed in (False, True):
        fn, x, w, b, slab = _bf16_layer(kind, kw, r, B, H, c_in, c_out, 7,
                                        armed)
        assert slab.dtype is torch.float32
        xc, wc, bc, sc = (t.to(card) for t in (x, w, b, slab))
        extra = dict(checksum=True) if armed else {}
        plain = fn(x, w, b, slab, relu=True, **kw, **extra)
        plain = plain[0] if armed else plain
        for tile in mod.TILES:
            kwt = dict(kw, tile_rows=tile[0], tile_cols=tile[1])
            if tile not in mod.ANY_SLAB_TILES and mod.plan(
                    tuple(x.shape), tuple(w.shape), **kw).Kb % 4:
                continue
            y = fn(xc, wc, bc, sc, relu=True, **kwt, **extra)
            y32 = fn(xc.float(), wc.float(), bc.float(), sc.float(),
                     relu=True, **kwt, **extra)
            if armed:
                (y, v), (y32, _) = y, y32
                assert int(v) == 0, tile
            torch.cuda.synchronize()
            assert y.dtype is torch.bfloat16
            assert torch.equal(y.view(torch.int16),
                               y32.to(torch.bfloat16).view(torch.int16)), \
                (tile, armed)
        assert _within_one_step(y, plain) <= 0, armed


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv1_full", "conv2_full",
                                  "g2_c4_lrn_pool", "lrn_k130_epilogue"])
def test_bf16_slab_route_repeats_its_bits_at_every_tile(card, name):
    """Kernel 1's bf16-slab (tensor-core) route, twice at every tile of its
    list: equal bits each time and at every tile (no split-K, no atomics,
    a fixed k-step order); a NaN weight of tap (0, 0) and a NaN pixel stay
    non-finite wherever the f32 kernel on the widened inputs has them."""
    kind, _, kw, r, B, H, c_in, c_out = next(c for c in BF16_CASES
                                             if c[1] == name)
    fn, x, w, b, slab = _bf16_layer(kind, kw, r, B, H, c_in, c_out, 12,
                                    False)
    xc, wc, bc, sc = (t.to(card) for t in (x, w, b, slab))
    n0 = direct.launches
    first = fn(xc, wc, bc, sc, relu=True, **kw)
    for tile in direct.MMA_TILES:
        kwt = dict(kw, tile_rows=tile[0], tile_cols=tile[1])
        for _ in range(2):
            y = fn(xc, wc, bc, sc, relu=True, **kwt)
            torch.cuda.synchronize()
            assert torch.equal(y.view(torch.int16),
                               first.view(torch.int16)), tile
    assert direct.launches == n0 + 1 + 2 * len(direct.MMA_TILES)
    w[0, 0, 0, 1] = float("nan")
    x[0, 2, 3, 0] = float("nan")
    p = direct.plan(tuple(x.shape), tuple(w.shape), **{
        k: v for k, v in kw.items() if k != "lrn"})
    bad = direct.pack_weights(w, p).to(card)
    xc, wc = x.to(card), w.to(card)
    y = fn(xc, wc, bc, bad, relu=True, **kw)
    y32 = fn(xc.float(), wc.float(), bc.float(), bad.float(), relu=True,
             **kw)
    torch.cuda.synchronize()
    assert (~torch.isfinite(y32)).any()
    assert bool((~torch.isfinite(y) >= ~torch.isfinite(y32)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv1_full", "conv2_full",
                                  "conv2_reduced"])
def test_bf16_armed_direct_slab_verdict_equals_plain(card, name):
    """Seeded flips in a bf16 direct slab (16-bit checksum lanes, the
    checksum row included): the kernel's verdict is the plain count."""
    kind, _, kw, r, B, H, c_in, c_out = next(c for c in BF16_CASES
                                             if c[1] == name)
    fn, x, w, b, slab = _bf16_layer(kind, kw, r, B, H, c_in, c_out, 8, True)
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    nbits = slab.numel() * 16
    rng = np.random.default_rng(len(name))
    p = direct.plan(tuple(x.shape), tuple(w.shape), checksum=True, **{
        k: v for k, v in kw.items() if k != "lrn"})
    flips = [[int(v)] for v in rng.integers(0, nbits, size=10)]
    flips += [[16 * p.Cb * p.Kb + 3], [nbits - 1],
              [int(v) for v in rng.integers(0, nbits, size=4)]]
    for bits in flips:
        bad = _flip_bits(slab, bits)
        _, v = fn(xc, wc, bc, bad.to(card), relu=True, checksum=True, **kw)
        want = int(dma.checksum_mismatches(bad))
        assert int(v) == want > 0, (bits, int(v), want)


@pytest.mark.cuda
@pytest.mark.parametrize("H,c_in,c_out,pooled", VGG_CASES, ids=VGG_IDS)
def test_winograd_kernels_at_vgg_geometries(card, H, c_in, c_out, pooled):
    """Kernels 2-3 at each VGG-16 layer geometry (batch 2): f32 against
    the plain version, and the bf16 rule; one launch a call."""
    kw = dict(pool=(2, 2)) if pooled else {}
    x, w, b = _inputs(9, 2, H, c_in, c_out, 3, 1)
    n0 = winograd.fused_launches if pooled else winograd.launches
    got, ref = _both(lambda x, w, b: winograd.conv2d_winograd(
        x, w, b, relu=True, **kw), card, x, w, b)
    assert (winograd.fused_launches if pooled else winograd.launches) \
        == n0 + 1
    _close(got, ref)
    xc, wc, bc = (torch.from_numpy(a).to(card).to(torch.bfloat16)
                  for a in (x, w, b))
    y = winograd.conv2d_winograd(xc, wc, bc, relu=True, **kw)
    y32 = winograd.conv2d_winograd(xc.float(), wc.float(), bc.float(),
                                   relu=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int16),
                       y32.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_bf16_engine_on_the_card_matches_the_cpu(card, arch):
    """A reduced bf16 model served on the card: logits bit-equal to
    ``apply`` on the card at the served bucket, and within one bf16 step
    of the CPU plain versions' logits a layer (5e-2 * max|logit|)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True,
                              dtype="bfloat16")
    params = alexnet.init(0, cfg, device="cpu")
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((4, cfg.image_size, cfg.image_size, 3)
                               ).astype(np.float32)
    dev = {k: {n: t.to(card) for n, t in v.items()}
           for k, v in params.items()}
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=4), params=dev,
                    device=card)
    reqs = [ImageRequest(image=im) for im in imgs]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    got = np.stack([r.logits for r in reqs])
    want = alexnet.apply(dev, cfg, torch.from_numpy(imgs).to(card))
    assert np.array_equal(got, want.float().cpu().numpy())
    cpu = alexnet.apply(params, cfg, torch.from_numpy(imgs)).float().numpy()
    assert np.abs(got - cpu).max() <= 5e-2 * np.abs(cpu).max()


@pytest.mark.cuda
def test_checkpoint_restores_bf16_onto_the_card(card, tmp_path):
    """A bf16 checkpoint written from the card comes back on the card,
    bit for bit."""
    from repro_torch import checkpoint as ckpt
    cfg = dataclasses.replace(get_config("vgg16").reduced(),
                              dtype="bfloat16")
    params = alexnet.init(2, cfg, device=card)
    ckpt.save(str(tmp_path), {"step": 1, "params": params})
    got = ckpt.restore(str(tmp_path), {"step": 0, "params": alexnet
                                       .empty_params(cfg, device=card)})
    for layer, sub in params.items():
        for k, v in sub.items():
            t = got["params"][layer][k]
            assert t.device.type == "cuda" and t.dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16), v.view(torch.int16))


@pytest.mark.cuda
def test_supervised_fleet_on_the_card(card, tmp_path):
    """Two worker processes on the card serve reduced AlexNet on route
    pallas; w0 is killed mid-flight: the fleet balances, every request
    completes bit-equal to ``apply`` on the card at its served bucket,
    and every worker, the respawned w0 included, names the card and
    launched the conv kernels."""
    from repro_torch.serving import Supervisor, SupervisorConfig, WorkerModel
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True)
    sup = Supervisor((WorkerModel("alexnet", cfg, CnnServeConfig(
        max_batch=2)),), SupervisorConfig(n_workers=2, max_restarts=1),
        ckpt_dir=str(tmp_path), device="cuda")
    rng = np.random.default_rng(6)
    with sup:
        reqs = [ImageRequest(image=im, deadline_ms=60_000.0)
                for im in rng.standard_normal(
                    (8, cfg.image_size, cfg.image_size, 3)).astype(
                        np.float32)]
        for r in reqs:
            sup.submit("alexnet", r)
        sup.kill_worker("w0", "test-kill")
        acc = sup.run_until_done(max_steps=5000)
        assert acc["balanced"] and acc["completed"] == 8
        assert acc["failed_over"] > 0
        t0 = time.monotonic()
        while not sup.workers["w0"].alive and time.monotonic() - t0 < 300:
            sup.step()
            time.sleep(0.05)
        assert sup.workers["w0"].restored == {"alexnet": 1}
        sup.workers["w1"].alive = False       # serve through the respawn
        more = [ImageRequest(image=im) for im in rng.standard_normal(
            (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)]
        for r in more:
            assert sup.submit("alexnet", r)
        sup.workers["w1"].alive = True
        sup.run_until_done(max_steps=5000)
        sup.step()                  # refresh every heartbeat report
        par = sup.verify_bit_parity(uids=[r.uid for r in reqs + more])
        assert par == {"checked": 11, "mismatched": 0, "bad_uids": []}
        name = torch.cuda.get_device_name(0)
        for h in sup.workers.values():
            assert h.device_name == name
            assert h.last_launches["conv_direct"] > 0
            assert h.last_launches["conv_winograd"] > 0
            assert not any(h.last_degradations.values())
        deaths = [e for e in sup.events if e["event"] == "death"]
        assert deaths and deaths[0]["launches"] is not None


# ---------------------------------------------------------------------------
# training: kernel 7 forward and backward inside a step
# ---------------------------------------------------------------------------
def _train_loss_grads(params, cfg, batch):
    from repro_torch.nn.module import tree_leaves
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
def test_reduced_mamba_train_step_kernel_route_vs_plain(card, monkeypatch):
    """One loss and gradient of a reduced mamba2-2.7b (f32, remat on) on
    the card: kernel 7 forward twice a layer (the remat recompute), its
    backward kernels once, kernel 6 never (the scan trains on its twin);
    against the plain route (pallas=False) on the card and against the
    CPU: loss within 1e-5 relative, each gradient within 1e-4 * max|g|."""
    import functools
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              remat=True)
    params = lm.init(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 41))
    batch = {"inputs": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}

    def on(dev):
        return (lm.to_device(params, dev), cfg,
                {k: v.to(dev) for k, v in batch.items()})

    ops.reset_launch_counts()
    ssd_ops.reset_launch_counts()
    kern = _train_loss_grads(*on(card))
    torch.cuda.synchronize()
    n = ops.launch_counts()
    L = cfg.num_layers
    assert (n["dw1d"], n["dw1d_bwd"], n["dw1d_wgrad"]) == (2 * L, L, L)
    assert ssd_ops.launch_counts()["ssd"] == 0
    cpu = _train_loss_grads(*on("cpu"))
    monkeypatch.setattr(ops, "conv1d_depthwise_causal", functools.partial(
        ops.conv1d_depthwise_causal, pallas=False))
    plain = _train_loss_grads(*on(card))
    assert ops.launch_counts()["dw1d"] == 2 * L
    for ref in (plain, cpu):
        np.testing.assert_allclose(float(kern[0]), float(ref[0]), rtol=1e-5)
        for g, r in zip(kern[1], ref[1]):
            r = r.to(card)
            assert float((g - r).abs().max()) <= 1e-4 * float(
                r.abs().max())


@pytest.mark.cuda
def test_trainer_on_the_card_matches_the_cpu(card, tmp_path):
    """A reduced smollm-360m trained 6 steps on the card through the
    stream buffer's pinned side-stream copies, with a checkpoint: the loss
    falls and the params agree with a CPU run within the reference's
    restart bound."""
    from repro_torch.nn.module import tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config("smollm-360m").reduced()
    params = lm.init(0, cfg, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        tcfg = TrainerConfig(steps=6, batch=4, seq_len=32, log_every=1,
                             base_lr=3e-3, warmup=1, ckpt_every=3,
                             ckpt_dir=str(tmp_path / dev))
        tr = Trainer(cfg, tcfg, params=lm.to_device(params, dev),
                     device=dev)
        runs[dev] = (tr, tr.run())
    tr, hist = runs["cuda"]
    assert tr.device.type == "cuda" and len(hist) == 6
    assert hist[-1]["loss"] < hist[0]["loss"]
    for x, y in zip(tree_leaves(tr.state["params"]),
                    tree_leaves(runs["cpu"][0].state["params"])):
        np.testing.assert_allclose(x.detach().cpu().numpy(),
                                   y.detach().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_stream_buffer_on_the_card(card):
    from repro_torch.core.streambuf import StreamBuffer
    src = [{"inputs": np.full((4, 8), i, np.int32)} for i in range(6)]
    out = []
    for b in StreamBuffer(iter(src), device=card):
        assert b["inputs"].is_cuda
        out.append(int(b["inputs"].sum()))
    assert out == [32 * i for i in range(6)]


# the mixture-of-experts layer and the MoE / MLA models -----------------------
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _moe_layer(arch, S, dev, seed=0):
    cfg = get_config(arch).reduced()
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return cfg, lm.to_device(p, dev), torch.from_numpy(x).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 20, 1])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_on_the_card_matches_the_cpu(card, arch, S):
    """f32: the routed experts equal the CPU's, y within 1e-5 * max|y|
    (cuBLAS sums in another order), the router loss within 1e-6."""
    out = {}
    for dev in ("cpu", card):
        cfg, p, x = _moe_layer(arch, S, dev)
        y, aux = moe.moe_apply(p, cfg, x, return_aux=True)
        idx = moe.route(p, cfg, moe.group(cfg, x)[0])[2]
        out[str(dev)] = (y.cpu(), float(aux), idx.cpu())
    (y0, a0, i0), (y1, a1, i1) = out["cpu"], out[str(card)]
    assert torch.equal(i0, i1)
    assert float((y1 - y0).abs().max()) <= 1e-5 * float(y0.abs().max())
    assert abs(a1 - a0) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_on_the_card_is_deterministic(card, arch):
    """Two runs of the one-hot route on the card are bit-equal."""
    cfg, p, x = _moe_layer(arch, 20, card)
    a, _ = moe.moe_apply(p, cfg, x)
    b, _ = moe.moe_apply(p, cfg, x)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_on_the_card_matches_the_cpu(card, arch, mode):
    """Reduced granite-moe-1b-a400m (kernel 5 in decode) and
    deepseek-v2-lite-16b (absorbed MLA, no kernel) in f32: logits within
    1e-4 * max|logit| of the CPU's, in every mode."""
    cfg = get_config(arch).reduced()
    params = lm.init(0, cfg, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 11)))
    new = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    lens = torch.tensor([11, 6])
    out = {}
    for dev in ("cpu", card):
        p = lm.to_device(params, dev)
        if mode == "train":
            logits, _, _ = lm.apply(p, cfg, toks.to(dev))
        else:
            caches = lm.cache_init(cfg, 2, 24, device=dev)
            logits, caches, _ = lm.apply(p, cfg, toks.to(dev),
                                         mode="prefill", caches=caches)
            if mode == "decode":
                n0 = decode_attn.launches
                logits, _, _ = lm.apply(p, cfg, new.to(dev), mode="decode",
                                        length=lens.to(dev), caches=caches)
                if dev == card:
                    want = cfg.num_layers if cfg.mla is None else 0
                    assert decode_attn.launches - n0 == want
        out[str(dev)] = logits.cpu()
    ref, got = out["cpu"], out[str(card)]
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_mla_engine_on_the_card_matches_the_cpu(card):
    """Reduced deepseek-v2-lite-16b served on the card: the CPU engine's
    greedy tokens, and no kernel-5 launch (MLA decodes in the absorbed
    form)."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = lm.init(0, cfg, device="cpu")
    scfg = ServeConfig(max_batch=3, max_len=64, prefill_bucket=16)
    out = {}
    for dev in ("cpu", card):
        eng = Engine(cfg, scfg, params=lm.to_device(params, dev), device=dev)
        reqs = [Request(prompt=list(range(1, n + 1)), max_new=5)
                for n in (5, 12, 3, 20)]
        for r in reqs:
            eng.submit(r)
        n0 = decode_attn.launches
        eng.run_until_done()
        out[str(dev)] = [r.generated for r in reqs]
        assert decode_attn.launches == n0
    assert out["cpu"] == out[str(card)]


# kernel 5 at head_dim 96, in MHA (G = 1) and over an encoder's cache ---------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [(3, 77, 4, 4, 96), (2, 300, 8, 2, 96),
                                        (4, 100, 6, 6, 64),
                                        (8, 448, 6, 6, 64),
                                        (8, 1500, 6, 6, 64),
                                        (2, 1088, 32, 32, 96)])
def test_decode_attn_head_dim_96_and_mha(card, dtype, B, S, H, KV, D):
    """D = 96 (phi-3-vision-4.2b's, no power of two; G = 4 and 1) and MHA
    at whisper-tiny's D = 64: small shapes, the self cache of 448
    positions, the cross cache of 1,500 rows (no multiple of the split)
    and phi-3-vision's 1,088 positions; ragged lengths with S and 1;
    two calls bit-equal."""
    q, k, v, lens = _decode_inputs(B + S + D, B, S, H, KV, D, dtype, card)
    got = _decode_check(q, k, v, lens, dtype)
    again = decode_attn.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_per_slot_cross_lengths(card, dtype):
    """The cross decode's lengths: one slot at 1,500 encoder rows, the rest
    at 750 (and one at 1); each slot's output equals the kernel over its
    own rows alone, whatever the rows past them hold."""
    B, S, H, KV, D = 8, 1500, 6, 6, 64
    q, k, v, _ = _decode_inputs(21, B, S, H, KV, D, dtype, card)
    lens = torch.tensor([S] + [750] * 6 + [1], dtype=torch.int32,
                        device=card)
    got = _decode_check(q, k, v, lens, dtype)
    for b in (0, 1, 7):
        n = int(lens[b])
        alone = decode_attn.decode_attention(
            q[b:b + 1], k[b:b + 1, :n].contiguous(),
            v[b:b + 1, :n].contiguous(),
            torch.tensor([n], dtype=torch.int32, device=card))
        _decode_close(got[b:b + 1], alone, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_encdec_and_vlm_engines_on_the_card_match_the_cpu(card, arch):
    """The reduced models served on the card (f32): the CPU engine's
    greedy tokens; kernel 5 once a layer a decode step, twice for the
    encoder-decoder (the self and the cross cache).  Whisper's requests
    carry 16, 8 and 3 frames over a cross cache of 16 rows."""
    from repro_torch.models import model_for
    cfg = get_config(arch).reduced()
    mod = model_for(cfg)
    params = mod.init(0, cfg, device="cpu")
    audio = cfg.family == "audio"
    scfg = ServeConfig(max_batch=3, max_len=64, prefill_bucket=16,
                       cross_len=16 if audio else 0)
    rng = np.random.default_rng(4)
    extras = [({"frames": (rng.standard_normal((T, cfg.d_model)) * 0.5)
                .astype(np.float32)} if audio else
               {"patches": (rng.standard_normal((cfg.num_patches, 1024))
                            * 0.1).astype(np.float32)})
              for T in (16, 8, 3, 16)]
    out = {}
    for dev in ("cpu", card):
        eng = Engine(cfg, scfg, params=lm.to_device(params, dev), device=dev)
        reqs = [Request(prompt=list(range(1, n + 1)), max_new=5, **x)
                for n, x in zip((5, 12, 3, 20), extras)]
        for r in reqs:
            eng.submit(r)
        n0 = decode_attn.launches
        eng.run_until_done()
        out[str(dev)] = [r.generated for r in reqs]
        if dev == card:
            assert decode_attn.launches - n0 == \
                cfg.num_layers * (2 if audio else 1) * eng.decode_steps
    assert out["cpu"] == out[str(card)]


# the hybrid family, BFP-compressed linears and MoE training ------------------
@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_hybrid_engine_on_the_card_matches_the_cpu(card, quantized):
    """Reduced jamba-v0.1-52b served on the card, as it is and with every
    linear BFP-compressed: the CPU engine's greedy tokens; kernels 6 and 7
    once per Mamba layer a prefill, kernel 5 once per attention layer a
    decode step."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = lm.init(0, cfg, device="cpu")
    if quantized:
        params = lm.quantize_linear_tree(params, cfg, min_size=256)
    n_ssm = sum(m == "ssm" for m, _ in
                (cfg.layer_kind(i) for i in range(cfg.num_layers)))
    scfg = ServeConfig(max_batch=3, max_len=64)
    prompts = [list(range(1, n + 1)) for n in (5, 3, 20, 9)]
    out = {}
    for dev in ("cpu", card):
        eng = Engine(cfg, scfg, params=lm.to_device(params, dev), device=dev)
        reqs = [Request(prompt=p, max_new=5) for p in prompts]
        for r in reqs:
            eng.submit(r)
        n5, n6, n7 = (decode_attn.launches, ssd.launches,
                      winograd.dw1d_launches)
        eng.run_until_done()
        out[str(dev)] = [r.generated for r in reqs]
        if dev == card:
            assert ssd.launches - n6 == n_ssm * len(prompts)
            assert winograd.dw1d_launches - n7 == n_ssm * len(prompts)
            assert decode_attn.launches - n5 == \
                (cfg.num_layers - n_ssm) * eng.decode_steps
    assert out["cpu"] == out[str(card)]


@pytest.mark.cuda
def test_quantize_linear_tree_on_the_card_is_the_cpus(card):
    """quantize_linear_tree on the card gives the CPU's bits (powers of
    two from their bits on both), and the dequantized weights equal."""
    from repro_torch.core import bfp as core_bfp
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = lm.init(2, cfg, device="cpu")
    a = lm.quantize_linear_tree(params, cfg, min_size=256)
    b = lm.quantize_linear_tree(lm.to_device(params, card), cfg,
                                min_size=256)
    from repro_torch.nn.module import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y.cpu())
    w = a["stack"][1]["moe"]["experts"]
    wc = b["stack"][1]["moe"]["experts"]
    assert torch.equal(core_bfp.dequantize_linear(w, "w1"),
                       core_bfp.dequantize_linear(wc, "w1").cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_moe_trainer_on_the_card_matches_the_cpu(card, arch):
    """Reduced granite (MoE every layer) and jamba (the hybrid: kernel 7
    forward and backward in every Mamba layer) trained 4 steps on the
    card: the router loss in every step, the params within the
    reference's restart bound of a CPU run."""
    from repro_torch.nn.module import tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config(arch).reduced()
    params = lm.init(0, cfg, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        tcfg = TrainerConfig(steps=4, batch=2, seq_len=32, log_every=1,
                             warmup=1)
        tr = Trainer(cfg, tcfg, params=lm.to_device(params, dev),
                     device=dev)
        runs[dev] = (tr, tr.run())
    tr, hist = runs["cuda"]
    assert len(hist) == 4 and all(h["aux_loss"] > 0 for h in hist)
    for h, c in zip(hist, runs["cpu"][1]):
        np.testing.assert_allclose(h["loss"], c["loss"], rtol=1e-4)
    for x, y in zip(tree_leaves(tr.state["params"]),
                    tree_leaves(runs["cpu"][0].state["params"])):
        np.testing.assert_allclose(x.detach().cpu().numpy(),
                                   y.detach().numpy(), rtol=1e-4, atol=1e-5)


# --- BFP in bf16: kernel 1 on an f32 slab, kernel 4 on bf16 x -------------
def _bf16_bfp_layer(kind, kw, r, B, H, c_in, c_out, seed, armed):
    """(entry, x, w, b, slab, plan) in bf16 with the reference's conv_bfp
    slab: packed from the bf16 filters, BFP-quantized to f32 (the checksum
    row taken off and computed again when armed), as
    ``nn.conv._pack_for_plan`` packs it."""
    from repro_torch.core import bfp as core_bfp
    fn, x, w, b, slab = _bf16_layer(kind, kw, r, B, H, c_in, c_out, seed,
                                    armed)
    mod = direct if kind == "direct" else winograd
    p = mod.plan(tuple(x.shape), tuple(w.shape), checksum=armed, **{
        k: v for k, v in kw.items() if k != "lrn" or mod is winograd})
    rows = slab[..., :-1, :] if armed else slab
    slab = core_bfp.quantize_dequantize(rows, block=np.gcd(p.Cb, 32),
                                        axis=-2)
    if armed:
        slab = dma.append_checksum_row(slab)
    assert slab.dtype is torch.float32
    return fn, x, w, b, slab, p


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name,kw,r,B,H,c_in,c_out", BF16_CASES)
def test_bf16_x_on_bfp_slabs_follows_the_rule_at_every_tile(
        card, kind, name, kw, r, B, H, c_in, c_out):
    """A bf16 BFP model's layers: bf16 x and bias on the f32 BFP slab
    (kernel 1's new pairing, and kernels 2-3's) are bit-equal, at every
    tile, armed and unarmed, to the f32 kernel on the widened x and bias
    rounded to bf16; armed verdicts 0 on the clean slab; within one bf16
    step of the plain version."""
    mod = direct if kind == "direct" else winograd
    for armed in (False, True):
        fn, x, w, b, slab, p = _bf16_bfp_layer(kind, kw, r, B, H, c_in,
                                               c_out, 9, armed)
        xc, wc, bc, sc = (t.to(card) for t in (x, w, b, slab))
        extra = dict(checksum=True) if armed else {}
        plain = fn(x, w, b, slab, relu=True, **kw, **extra)
        plain = plain[0] if armed else plain
        for tile in mod.TILES:
            if tile not in mod.ANY_SLAB_TILES and p.Kb % 4:
                continue
            kwt = dict(kw, tile_rows=tile[0], tile_cols=tile[1])
            y = fn(xc, wc, bc, sc, relu=True, **kwt, **extra)
            y32 = fn(xc.float(), wc.float(), bc.float(), sc, relu=True,
                     **kwt, **extra)
            if armed:
                (y, v), (y32, _) = y, y32
                assert int(v) == 0, tile
            torch.cuda.synchronize()
            assert y.dtype is torch.bfloat16
            assert torch.equal(y.view(torch.int16),
                               y32.to(torch.bfloat16).view(torch.int16)), \
                (tile, armed)
        got, ref = y.float().cpu().numpy(), plain.float().numpy()
        excess = np.abs(got - ref) - (2.0 ** -7 * np.abs(ref)
                                      + 1e-5 * np.abs(ref).max())
        assert excess.max() <= 0, (armed, excess.max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv1_full", "conv2_full"])
def test_bf16_x_bfp_direct_slab_verdict_equals_plain(card, name):
    """Seeded flips of an armed f32 BFP direct slab under bf16 x: the
    kernel's verdict is the plain count (32-bit lanes)."""
    case = next(c for c in BF16_CASES if c[1] == name)
    fn, x, w, b, slab, _ = _bf16_bfp_layer(*case[:1], *case[2:], seed=3,
                                           armed=True)
    kw = case[2]
    rng = np.random.default_rng(5)
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    for bit in rng.integers(0, slab.numel() * 32, size=6):
        bad = _flip_bits(slab, [int(bit)])
        _, v = fn(xc, wc, bc, bad.to(card), relu=True, checksum=True, **kw)
        assert int(v) == int(dma.checksum_mismatches(bad)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,block", BFP_SHAPES)
@pytest.mark.parametrize("M", [1, 3, 8, 13])
def test_bfp_kernel_reads_bf16_x_as_its_widening(card, M, K, N, block):
    """Kernel 4 on bf16 x: bit-equal to the f32 kernel on x.float() and to
    the plain version, with the pre-pass's bytes those of
    quantize_activations; no cast launch (one launch a call)."""
    x, w = _bfp_inputs(M, M, K, N, block)
    xc = torch.from_numpy(x).to(card, torch.bfloat16)
    wq, we = bfp.quantize_weights(torch.from_numpy(w).to(card), block=block)
    n0 = bfp.launches
    got, scratch = bfp._bfp_matmul_cuda(xc, wq, we, block=block)
    torch.cuda.synchronize()
    assert bfp.launches == n0 + 1
    assert torch.equal(got, bfp.bfp_matmul(xc.float(), wq, we, block=block))
    assert torch.equal(got.cpu(), bfp.bfp_matmul_plain(
        xc.cpu(), wq.cpu(), we.cpu(), block=block))
    words, exps = bfp.quantize_activations(xc, block)
    assert torch.equal(scratch[:words.numel()].view(words.shape), words)
    assert torch.equal(scratch[words.numel():].view(exps.shape), exps)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_bf16_bfp_engine_on_the_card_matches_the_cpu(card, arch):
    """A reduced bf16 model with fc_bfp and conv_bfp (armed) served on the
    card: verdict 0, each request's logits within one bf16 step of the CPU
    engine's (the plain versions), the launches of kernels 1-4."""
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True,
                              dtype="bfloat16", fc_bfp=True, conv_bfp=True)
    if arch == "vgg16":
        # reduced VGG-16's fc8 (K = 24) takes exponent blocks of 8, which
        # kernel 4 is not built for (its blocks are 16 and 32; the
        # reference's kernel does not compile there either: ROADMAP Queue
        # 3); fc7 32 wide gives fc8 blocks of 32
        cfg = dataclasses.replace(cfg, fc_dims=(32, 32, 10))
    params = alexnet.init(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((5, cfg.image_size, cfg.image_size,
                                3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: {n: t.to(dev) for n, t in v.items()}
             for k, v in params.items()}
        eng = CnnEngine(dataclasses.replace(cfg, sdc_abft=True),
                        CnnServeConfig(max_batch=4), params=p, device=dev)
        ops.reset_launch_counts()
        bfp_ops.reset_launch_counts()
        reqs = [ImageRequest(image=im) for im in imgs]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert eng.stats()["sdc"]["detections"] == 0
        out[dev] = np.stack([r.logits for r in reqs])
        if dev == "cuda":
            assert bfp_ops.launch_counts()["bfp_matmul"] > 0
            assert sum(ops.launch_counts().values()) > 0
    excess = np.abs(out["cuda"] - out["cpu"]) - (
        BF16_STEP * np.abs(out["cpu"]) + 1e-2 * np.abs(out["cpu"]).max())
    assert excess.max() <= 0


# --- kernels 2-3 at every F(m,3) -------------------------------------------
WINO_M_CASES = [c for c in WINO_CASES if c[0] in (
    "conv3_full", "conv5_full", "conv4_reduced", "lrn_pool_kblocks_g2",
    "ragged_c5_k40_pool", "kb_not_x4_g2")]


def _m_tol(x, w, b, kw, m, got_plain):
    """max(1e-5, 3 e(m)) * max|plain|: e(m) the plain version's error
    against the direct oracle in float64."""
    from repro_torch.kernels.conv.ref import conv2d_ref
    ref64 = conv2d_ref(x.double(), w.double(), b.double(), relu=True,
                       padding=kw.get("padding", "SAME"),
                       groups=kw.get("groups", 1), lrn=kw.get("lrn"),
                       pool=kw.get("pool"))
    e_m = float((got_plain.double() - ref64).abs().max()) / float(
        ref64.abs().max())
    return max(1e-5, 3 * e_m) * float(got_plain.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", list(winograd.CONV_MS))
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out", WINO_M_CASES)
def test_winograd_kernels_at_every_m(card, m, name, kw, B, H, c_in, c_out):
    """F(m,3) for m = 2..10: within max(1e-5, 3 e(m)) of the plain version;
    every tile bit-equal to the default, armed and unarmed, verdict 0; a
    flipped slab bit gives the plain count; bf16 x bit-equal to the f32
    kernel on the widened x, rounded."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(
        m, B, H, c_in, c_out, 3, kw.get("groups", 1)))
    p = winograd.plan(tuple(x.shape), tuple(w.shape), m=m, **kw)
    pa = winograd.plan(tuple(x.shape), tuple(w.shape), m=m, checksum=True,
                       **kw)
    slab, armed = winograd.pack_weights(w, p), winograd.pack_weights(w, pa)
    plain = winograd.conv2d_winograd(x, w, b, slab, m=m, relu=True, **kw)
    xc, wc, bc, sc, ac = (t.to(card) for t in (x, w, b, slab, armed))
    base = winograd.conv2d_winograd(xc, wc, bc, sc, m=m, relu=True, **kw)
    torch.cuda.synchronize()
    err = float((base.cpu() - plain).abs().max())
    assert err <= _m_tol(x, w, b, kw, m, plain), err
    for tile in winograd.TILES:
        if tile not in winograd.ANY_SLAB_TILES and p.Kb % 4:
            continue
        kwt = dict(kw, m=m, relu=True, tile_rows=tile[0], tile_cols=tile[1])
        y = winograd.conv2d_winograd(xc, wc, bc, sc, **kwt)
        y_arm, v = winograd.conv2d_winograd(xc, wc, bc, ac, checksum=True,
                                            **kwt)
        torch.cuda.synchronize()
        assert torch.equal(y.view(torch.int32), base.view(torch.int32)), tile
        assert torch.equal(y_arm.view(torch.int32),
                           base.view(torch.int32)), tile
        assert int(v) == 0, tile
    bad = _flip_bits(armed, [int(armed.numel() * 32 * 0.37)])
    _, v = winograd.conv2d_winograd(xc, wc, bc, bad.to(card), m=m,
                                    relu=True, checksum=True, **kw)
    assert int(v) == int(dma.checksum_mismatches(bad)) == 1
    x16, b16 = xc.to(torch.bfloat16), bc.to(torch.bfloat16)
    y16 = winograd.conv2d_winograd(x16, wc, b16, sc, m=m, relu=True, **kw)
    y32 = winograd.conv2d_winograd(x16.float(), wc, b16.float(), sc, m=m,
                                   relu=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y16.view(torch.int16),
                       y32.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 6, 10])
def test_dispatch_at_winograd_m_serves_a_model(card, m):
    """A reduced AlexNet whose 3x3 layers run F(m,3) (``ConvSpec``'s
    winograd_m through ``dispatch_conv``): the card's conv features within
    the F(m,3) tolerance of the CPU's."""
    from repro_torch.nn.conv import dispatch_conv
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True)
    params = alexnet.init(0, cfg, device="cpu")
    specs = [dataclasses.replace(s.with_route("pallas"), winograd_m=m)
             for s in alexnet.layer_specs(cfg)]
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    xs = {"cpu": x, "cuda": x.to(card)}
    for i, spec in enumerate(specs):
        pw = params[f"conv{i + 1}"]
        for dev in xs:
            xs[dev] = dispatch_conv(spec, xs[dev], pw["w"].to(dev),
                                    pw["b"].to(dev))
        if spec.winograd_eligible:
            ref = xs["cpu"]
            err = float((xs["cuda"].cpu() - ref).abs().max())
            assert err <= 1e-3 * float(ref.abs().max()), (i, err)
            xs["cuda"] = ref.to(card)


# --- kernel 7 at every tap count -------------------------------------------
DW1D_TAP_CASES = [(1, 200, 5120), (2, 33, 5), (3, 100, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("r", list(winograd.DW1D_TAPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", DW1D_TAP_CASES)
def test_dw1d_at_every_tap_count(card, monkeypatch, r, dtype, B, L, C):
    """F(m, r) at r = 2..11 (the reference's m): the forward within
    max(1e-5, 3 e(r)) of max|plain| (e(r): the plain version's own error
    against the direct shift-sum in float64), one bf16 step more in bf16,
    bit-equal at every tiles-a-block; dx bit-equal to flip(kernel
    7(flip(dy))); dw and db against their plain versions, two runs
    bit-equal; the autograd entry's gradients against the CPU's."""
    from repro_torch.kernels.conv.ref import conv1d_depthwise_causal_ref
    rng = np.random.default_rng(r * 100 + L)
    x = torch.from_numpy(rng.standard_normal((B, L, C)).astype(
        np.float32)).to(card, dtype)
    dy = torch.from_numpy(rng.standard_normal((B, L, C)).astype(
        np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.standard_normal((r, C)) * r ** -0.5).astype(
        np.float32)).to(card)
    b = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(
        np.float32)).to(card)
    n0 = winograd.dw1d_launches
    y = winograd.conv1d_depthwise_causal(x, w, b)
    torch.cuda.synchronize()
    assert winograd.dw1d_launches == n0 + 1 and y.dtype == dtype
    plain = winograd.conv1d_depthwise_causal_plain(x, w, b)
    exact = conv1d_depthwise_causal_ref(x.double(), w.double(), b.double())
    plain32 = winograd.conv1d_depthwise_causal_plain(x.float(), w, b)
    e_r = float((plain32.double() - exact).abs().max()) / float(
        exact.abs().max())
    bound = max(1e-5, 3 * e_r) * float(plain.float().abs().max())
    diff = (y.float() - plain.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff - BF16_STEP * plain.float().abs()
    assert float(diff.max()) <= bound, (e_r, float(diff.max()))
    for t in winograd.DW1D_TILES:
        monkeypatch.setattr(winograd, "dw1d_launch", lambda *a, t=t: t)
        assert torch.equal(winograd.conv1d_depthwise_causal(x, w, b), y), t
    monkeypatch.undo()
    zero = torch.zeros((C,), device=card)
    dx = winograd.conv1d_depthwise_causal_dx(dy, w)
    flip = winograd.conv1d_depthwise_causal(dy.flip(1).contiguous(), w,
                                            zero).flip(1)
    dw, db = winograd.conv1d_depthwise_causal_wgrad(x, dy, r)
    dw2, db2 = winograd.conv1d_depthwise_causal_wgrad(x, dy, r)
    torch.cuda.synchronize()
    assert torch.equal(dx, flip)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    pdw, pdb = winograd.conv1d_depthwise_causal_wgrad_plain(x, dy, r)
    _wgrad_close(dw, pdw, dtype, rel_step=False)
    _wgrad_close(db, pdb, dtype, rel_step=True)
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    ops.conv1d_depthwise_causal(*leaves).backward(dy)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (x, w, b)]
    ops.conv1d_depthwise_causal(*cpu).backward(dy.cpu())
    for got, ref in zip(leaves, cpu):
        g, rg = got.grad.float().cpu(), ref.grad.float()
        tol = max(1e-4, 3 * e_r) * float(rg.abs().max())
        if dtype == torch.bfloat16:
            tol = tol + BF16_STEP * rg.abs()
        assert float(((g - rg).abs() - tol).max()) <= 0


@pytest.mark.cuda
def test_dw1d_refuses_an_unbuilt_m_before_launching(card):
    x = torch.ones((1, 9, 4), device=card)
    n0 = winograd.dw1d_launches
    with pytest.raises(ValueError, match="built for r in 2..11"):
        winograd.conv1d_depthwise_causal(x, torch.ones((4, 4), device=card),
                                         m=2)
    assert winograd.dw1d_launches == n0


@pytest.mark.cuda
def test_mamba_at_three_taps_on_the_card_matches_the_cpu(card):
    """A reduced mamba2-2.7b at conv_kernel=3: the Engine's greedy tokens
    on the card equal the CPU's, and a training step's loss and gradients
    (kernel 7 forward twice a layer, its backward once) agree."""
    cfg = get_config("mamba2-2.7b").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, conv_kernel=3), remat=True)
    params = lm.init(0, cfg, device="cpu")
    prompts = [[5, 6, 7, 8], list(range(1, 20)), [9, 3, 4]]
    toks = {}
    for dev in ("cpu", "cuda"):
        e = Engine(cfg, ServeConfig(max_batch=2, max_len=48,
                                    prefill_bucket=8),
                   params=lm.to_device(params, dev), device=dev)
        rs = [Request(prompt=p, max_new=5) for p in prompts]
        for r in rs:
            e.submit(r)
        e.run_until_done()
        toks[dev] = [r.generated for r in rs]
    assert toks["cpu"] == toks["cuda"]
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab_size, (2, 41))
    batch = {"inputs": torch.from_numpy(t[:, :-1]),
             "targets": torch.from_numpy(t[:, 1:])}
    ops.reset_launch_counts()
    got = _train_loss_grads(lm.to_device(params, card), cfg,
                            {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    n = ops.launch_counts()
    L = cfg.num_layers
    assert (n["dw1d"], n["dw1d_bwd"], n["dw1d_wgrad"]) == (2 * L, L, L)
    ref = _train_loss_grads(params, cfg, batch)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for g, r in zip(got[1], ref[1]):
        assert float((g.cpu() - r).abs().max()) <= 1e-4 * float(
            r.abs().max())


# --- training the audio and vlm families -------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_audio_and_vlm_trainer_on_the_card_matches_the_cpu(card, arch,
                                                           tmp_path):
    """Reduced whisper-tiny and phi-3-vision trained 4 steps on the card
    (frames or patches through the stream buffer) with a checkpoint: finite
    losses, and the params within the restart bound of a CPU run but the
    key biases (AdamW steps their float noise, up to lr a step)."""
    from repro_torch.models import model_for
    from repro_torch.nn.module import tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config(arch).reduced()
    params = model_for(cfg).init(0, cfg, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        tcfg = TrainerConfig(steps=4, batch=2, seq_len=16, log_every=1,
                             warmup=1, ckpt_every=2,
                             ckpt_dir=str(tmp_path / dev))
        tr = Trainer(cfg, tcfg, params=lm.to_device(params, dev),
                     device=dev)
        runs[dev] = (tr, tr.run())
    tr, hist = runs["cuda"]
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    lr = TrainerConfig().base_lr
    for (name, x), y in zip(_named_leaves(tr.state["params"]),
                            tree_leaves(runs["cpu"][0].state["params"])):
        x, y = x.detach().cpu().numpy(), y.detach().numpy()
        if name.endswith("attn/wk/b"):
            assert np.abs(x - y).max() <= 2 * lr * 4, name
        else:
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def _named_leaves(tree, name=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{name}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{name}[{i}]")
    else:
        yield name, tree


# the mesh (one NCCL rank on the card) ---------------------------------------
@pytest.fixture
def nccl_rank(card):
    """A one-rank NCCL default process group on the card (a ``HashStore``),
    destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    init_process_group("cuda", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield card
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b"])
def test_mesh_trainer_on_the_card_matches_the_meshless(nccl_rank, arch):
    """A reduced model trained 3 steps on a (1, 1) ("data", "model") NCCL
    mesh: its DTensor state on the card, the losses and params within
    rtol 1e-4 / atol 1e-5 of the meshless trainer's from the same params
    (mamba2-2.7b through kernel 7 forward and backward)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.module import tree_leaves
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config(arch).reduced()
    params = lm.init(0, cfg, device="cpu")
    tcfg = TrainerConfig(steps=3, batch=4, seq_len=32, log_every=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    assert mesh.device_type == "cuda"
    meshed = Trainer(cfg, tcfg, mesh=mesh, params=params)
    plain = Trainer(cfg, tcfg, params=lm.to_device(params, "cuda"))
    leaf = tree_leaves(meshed.state["params"])[0]
    assert sh.is_dtensor(leaf) and leaf.to_local().is_cuda
    h_mesh, h_plain = meshed.run(), plain.run()
    np.testing.assert_allclose([h["loss"] for h in h_mesh],
                               [h["loss"] for h in h_plain], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(tree_leaves(meshed.state["params"]),
                    tree_leaves(plain.state["params"])):
        np.testing.assert_allclose(a.full_tensor().cpu().numpy(),
                                   b.detach().cpu().numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_data_parallel_engine_on_the_card_is_bit_equal(card):
    """``CnnEngine(data_parallel=True)`` over the visible cards serves the
    logits of ``data_parallel=False``, bit for bit, every request
    retired."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True)
    params = alexnet.init(0, cfg, device=card)
    imgs = np.random.default_rng(5).standard_normal(
        (7, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    logits = {}
    for dp in (True, False):
        eng = CnnEngine(cfg, CnnServeConfig(max_batch=4, data_parallel=dp),
                        params=params, device=card)
        reqs = [ImageRequest(image=im) for im in imgs]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done for r in reqs) and eng.accounting()["balanced"]
        logits[dp] = np.stack([r.logits for r in reqs])
    assert np.array_equal(logits[True], logits[False])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("smollm-360m", "decode"),
                                       ("mamba2-2.7b", "prefill"),
                                       ("mamba2-2.7b", "train")])
def test_dry_run_counts_the_launches_the_card_makes(card, arch, kind):
    """The dry run's count of a reduced step on meta tensors (chip_smoke
    phase 15b's check): its kernel launches by kernel equal to the
    wrappers' ``launch_counts()`` when the same step runs on the card
    (kernel 5 a decode step's attention layer, kernels 6 and 7 a
    prefill's Mamba layer, kernel 7 forward and backward a train step's)."""
    from repro_torch.config import ShapeCfg
    from repro_torch.launch import specs as sp
    from repro_torch.launch.dryrun import count_step
    from repro_torch.nn.module import tree_map
    from repro_torch.optim import init_state
    cfg = get_config(arch).reduced()
    shape = ShapeCfg(kind, 64, 4, kind)

    def args(dev):
        if kind == "train":
            state = (sp.state_specs(cfg) if dev == "meta" else
                     init_state(lm.init(0, cfg, device=dev)))
            batch = tree_map(lambda t: torch.zeros(
                tuple(t.shape), dtype=t.dtype, device=dev),
                sp.batch_specs(cfg, shape))
            return state, batch
        S = 1 if kind == "decode" else 64
        return (lm.init(0, cfg, device=dev),
                {"tokens": torch.zeros((4, S), dtype=torch.int32,
                                       device=dev)},
                lm.cache_init(cfg, 4, 64, device=dev))

    step = {"train": sp.make_train_step(cfg),
            "prefill": sp.make_prefill_step(cfg),
            "decode": sp.make_decode_step(cfg, shape)}[kind]
    counter, _, _ = count_step(step, *args("meta"))
    on_card = args("cuda")
    mods = (ops, bfp_ops, dec_ops, ssd_ops)
    for m in mods:
        m.reset_launch_counts()
    step(*on_card)
    torch.cuda.synchronize()
    launched = {k: v for m in mods for k, v in m.launch_counts().items()
                if v}
    assert dict(counter.launches) == launched
    assert launched
