"""Block floating point (paper §3.6) of the PyTorch port against the JAX
package, on the CPU.

Every input is made with numpy from a seed and handed to both packages;
the JAX BFP kernel runs in interpret mode, the port's wrapper takes its
kernel's plain PyTorch version on a CPU tensor.  Tolerances:
quantization (mantissas, exponents, reference-layout weight streams, the
direct-kernel slabs) is bit-equal where the JAX package's scales are exact
powers of two; the BFP matmul to rtol 1e-6, atol 1e-5
(the JAX package's own kernel-vs-oracle tolerance: the K-block sums run in
another order); reduced AlexNet logits to rtol 1e-4, atol 1e-4 * max|logit|
(``tests/test_torch_alexnet.py``'s); Winograd-domain slabs, whose
unquantized tiles already differ by up to 1e-6, to one quantization step
2^(e-7) per element.

The JAX package scales by ``jnp.exp2`` of an integer, and XLA's CPU exp2
(jax 0.9) misses the power of two by up to 4e-6 relative for arguments
beyond +-12.  The port builds every power of two from its bits.  Tests of
quantization use magnitudes whose scales stay where the JAX package is
exact; the model-level tests run the JAX side with ``exact_jax_exp2``,
because BFP values land on exact half-steps (an FC layer of one K-block
outputs dyadic values) where that error flips a mantissa.  The unpatched
JAX package is held to the port as well: its conv slabs and FC weight
streams within one quantization step per element, and each FC layer on
the model's own activations within the error of one step per quantized
element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import bfp as j_bfp  # noqa: E402
from repro.kernels.bfp_matmul import bfp_matmul as j_bk  # noqa: E402
from repro.kernels.bfp_matmul import ops as j_bops  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro.nn import conv as j_conv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bfp as t_bfp  # noqa: E402
from repro_torch.kernels.bfp_matmul import bfp_matmul as t_bk  # noqa: E402
from repro_torch.kernels.bfp_matmul import ops as t_bops  # noqa: E402
from repro_torch.kernels.bfp_matmul import ref as t_bref  # noqa: E402
from repro_torch.kernels.conv.dma import WeightStager  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest)

MATMUL_TOL = dict(rtol=1e-6, atol=1e-5)

# reduced AlexNet layer geometries: (name, spec kwargs, H, c_in, c_out)
LAYERS = [
    ("conv1", dict(kernel=11, stride=4, padding="VALID", relu=True,
                   fuse_lrn=True, fuse_pool=True), 35, 3, 16),
    ("conv2", dict(kernel=5, groups=2, relu=True, fuse_lrn=True,
                   fuse_pool=True), 13, 16, 32),
    ("conv3", dict(kernel=3, relu=True), 13, 32, 48),
    ("conv4", dict(kernel=3, groups=2, relu=True), 13, 48, 48),
    ("conv5", dict(kernel=3, groups=2, relu=True, fuse_pool=True),
     13, 48, 32),
]

FLAGS = {"fc": dict(fc_bfp=True), "conv": dict(conv_bfp=True),
         "both": dict(fc_bfp=True, conv_bfp=True)}
ROUTES = {"direct": dict(use_winograd=False), "pallas": dict(use_pallas=True)}


# block magnitudes 2^MAG keep the JAX package's scales exact: exponents
# e in [-5, 19] for 8 bits (scale 2^(7-e)), near 4 for 16 bits (2^(15-e))
MAG = {8: 0, 16: 3}


@pytest.fixture
def exact_jax_exp2(monkeypatch):
    """The JAX package's BFP code with ``jnp.exp2`` exact for the integer
    arguments it is given (``jnp.ldexp``): powers of two, as its
    quantization defines them.  Only its BFP modules call exp2; the jit
    caches are cleared around the test so no trace keeps the other one."""
    def exp2(v):
        v = jnp.asarray(v)
        return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                         jnp.round(v).astype(jnp.int32))
    jax.clear_caches()
    monkeypatch.setattr(jnp, "exp2", exp2)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _tie_rows(block, bits, rows=6, seed=0):
    """(rows, 4 * block) f32 along the last axis: random blocks, an
    all-zero block, and a block of constructed half-step ties whose max
    scales to qmax + 0.5 (rounds to qmax + 1, clips to qmax)."""
    rng = np.random.default_rng(seed)
    e = MAG[bits]
    x = (rng.standard_normal((rows, 4 * block)) * 2.0 ** (e + 1)).astype(
        np.float32)
    x[1, :block] = 0.0
    x[rows - 1] = 0.0
    qmax = 2 ** (bits - 1) - 1
    step = np.float32(2.0 ** (e - (bits - 1)))  # block max in [2^(e-1), 2^e)
    ties = np.array([0, 1, 2, 3, 10, 11, -1, -2, -4, qmax - 1, -qmax],
                    np.float32) + np.float32(0.5)
    blk = np.zeros(block, np.float32)
    blk[0] = (qmax + 0.5) * step
    blk[1:1 + len(ties)] = ties * step
    x[2, block:2 * block] = blk
    return x, ties, qmax


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_is_bit_equal_to_jax(axis, bits):
    """Mantissas and exponents bit-equal, including the all-zero blocks
    (e = 0, m = 0), half-step ties (half-to-even) and the clip at qmax."""
    block = 16
    rows, ties, qmax = _tie_rows(block, bits)
    x = rows if axis == -1 else np.ascontiguousarray(rows.T)
    jm, je, jax_axis = j_bfp.quantize(jnp.asarray(x), block=block, bits=bits,
                                      axis=axis)
    tm, te, t_axis = t_bfp.quantize(torch.from_numpy(x), block=block,
                                    bits=bits, axis=axis)
    assert t_axis == jax_axis
    assert tm.dtype == (torch.int8 if bits == 8 else torch.int16)
    assert te.dtype == torch.int8
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the constructed block, read back along the quantized axis
    blk = (tm.numpy()[2, 1] if axis == -1 else tm.numpy()[1, :, 2])
    assert blk[0] == qmax                       # qmax + 0.5 -> clip, no wrap
    np.testing.assert_array_equal(blk[1:1 + len(ties)], np.round(ties))
    zero = tm.numpy()[1, 0] if axis == -1 else tm.numpy()[0, :, 1]
    assert not zero.any()
    assert (te.numpy()[1, 0] if axis == -1 else te.numpy()[0, 1]) == 0


@pytest.mark.parametrize("bits", [8, 16])
def test_dequantize_and_error_bound_match_jax(bits):
    x = (np.random.default_rng(1).standard_normal((8, 96))
         * 2.0 ** (MAG[bits] + 1)).astype(np.float32)
    x[3, 32:64] *= 0.25
    got = t_bfp.quantize_dequantize(torch.from_numpy(x), block=32, bits=bits)
    ref = j_bfp.quantize_dequantize(jnp.asarray(x), block=32, bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, e, _ = t_bfp.quantize(torch.from_numpy(x), block=32, bits=bits)
    bound = t_bfp.error_bound(e, bits=bits)
    np.testing.assert_allclose(
        bound.numpy(), np.asarray(j_bfp.error_bound(jnp.asarray(e.numpy()),
                                                    bits=bits)), rtol=1e-5)
    err = np.abs(got.numpy() - x).reshape(8, 3, 32).max(-1)
    assert (err <= bound.numpy()).all()


@pytest.mark.parametrize("K,N,block", [(64, 48, 32), (96, 1000, 32),
                                       (48, 10, 16)])
def test_quantize_weights_reference_layout_matches_jax(K, N, block):
    """The port stages its own (K/4, N, 4) stream; in the reference's
    (KB, block, N) layout it is the JAX ``quantize_weights``, bit for
    bit."""
    w = np.random.default_rng(K + N).standard_normal((K, N)).astype(
        np.float32)
    jm, je = j_bk.quantize_weights(jnp.asarray(w), block=block)
    wq, we = t_bops.quantize_weights(torch.from_numpy(w), block=block)
    assert tuple(wq.shape) == (K // 4, N, 4) and wq.dtype == torch.int8
    np.testing.assert_array_equal(
        t_bk.reference_layout(wq, block).numpy(), np.asarray(jm))
    np.testing.assert_array_equal(we.numpy(), np.asarray(je))
    # a word holds 4 consecutive k of one column
    m = np.asarray(jm).reshape(K, N)
    np.testing.assert_array_equal(wq.numpy()[1, 5], m[4:8, 5])


@pytest.mark.parametrize("M,K,N,block", [(64, 256, 48, 32), (8, 64, 8, 32),
                                         (130, 512, 70, 64),
                                         (8, 96, 1000, 32)])
def test_plain_matches_jax_kernel(M, K, N, block):
    """The port's plain version against the JAX ``_bfp_kernel`` (interpret
    mode), at the JAX package's shapes and an fc8-like N = 1000."""
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    ref = np.asarray(j_bops.bfp_matmul(jnp.asarray(x), jnp.asarray(w),
                                       block=block, interpret=True))
    got = t_bops.bfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            block=block).numpy()
    np.testing.assert_allclose(got, ref, **MATMUL_TOL)
    oracle = t_bref.bfp_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   block=block).numpy()
    np.testing.assert_allclose(oracle, ref, **MATMUL_TOL)


def test_plain_is_the_ascending_f32_sum_of_exact_block_dots():
    """What the kernel is held to, spelled out in numpy: exact integer
    block dots, exact power-of-two scales, one f32 sum per output over the
    K-blocks in ascending order.  Bit-equal, zero K-blocks included."""
    rng = np.random.default_rng(5)
    M, K, N, block = 3, 160, 40, 32
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, 32:64] = 0.0
    x[1, 96:128] = np.maximum(x[1, 96:128], 0) * 1e-30
    w = rng.standard_normal((K, N)).astype(np.float32)
    wq, we = t_bops.quantize_weights(torch.from_numpy(w), block=block)
    got = t_bk.bfp_matmul(torch.from_numpy(x), wq, we, block=block).numpy()
    mx, ex, _ = t_bfp.quantize(torch.from_numpy(x), block=block, axis=1)
    mx, ex = mx.numpy().astype(np.int64), ex.numpy().astype(np.int64)
    mw = t_bk.reference_layout(wq, block).numpy().astype(np.int64)
    ew = we.numpy().astype(np.int64)
    acc = np.zeros((M, N), np.float32)
    for kb in range(K // block):
        dot = (mx[:, kb] @ mw[kb]).astype(np.float32)
        scale = np.ldexp(np.float32(1), ex[:, kb, None] + ew[kb] - 14)
        acc = acc + dot * scale.astype(np.float32)
    np.testing.assert_array_equal(got, acc)


# (M, K, N, block): fc6, fc7 and fc8 at the served bucket of 8, and the LM
# fc_bfp head (smollm-360m: d_model 960, vocab 49,152) at a decode batch
SERVED_FC = [(8, 9216, 4096, 32), (8, 4096, 4096, 32), (8, 4096, 1000, 32),
             (8, 960, 49152, 32)]


@pytest.mark.parametrize("M,K,N,block", SERVED_FC)
def test_gemm_grid_covers_the_card(M, K, N, block):
    """At least 119 blocks (90% of one wave of the H100's 132 SMs) at every
    served FC layer; the scratch holds the pre-pass's words and exponents
    of the padded 8-row tiles."""
    cols = t_bk.tile_cols(M, N)
    assert cols in t_bk.TILE_COLS
    grid = t_bk.bfp_grid(M, N)
    assert grid == (-(-N // cols), -(-M // t_bk.TILE_ROWS))
    assert grid[0] * grid[1] >= 119, grid
    words, exps = t_bk.scratch_shapes(M, K, block)
    assert words == (-(-M // 8), K // 4, 8)
    assert exps == (-(-M // 8), K // block, 8)


def _activations(M, K, block, seed):
    """ReLU-like rows with an all-zero K-block, an all-zero row, and (for
    the poisoned variant) a NaN and an infinity in two K-blocks."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((M, K)), 0).astype(np.float32)
    x[:, block:2 * block] = 0.0
    x[M - 1] = 0.0
    return x


@pytest.mark.parametrize("M,K,N,block", SERVED_FC[:3] + [(13, 4096, 1000, 32),
                                                        (3, 48, 10, 16)])
@pytest.mark.parametrize("poison", [False, True])
def test_quantize_activations_unpacks_to_quantize_rows(M, K, N, block,
                                                       poison):
    """The pre-pass's twin, unpacked: 4 k a word (byte i = k offset i), the
    8 rows of a tile side by side, zero rows past M; the bad-block exponent
    where a K-block holds a NaN or an infinity."""
    x = _activations(M, K, block, M + K)
    if poison:
        x[0, 3], x[M - 2, K - 1] = np.nan, np.inf
    xt = torch.from_numpy(x)
    words, exps = t_bk.quantize_activations(xt, block)
    assert words.dtype == exps.dtype == torch.int32
    assert tuple(words.shape) == t_bk.scratch_shapes(M, K, block)[0]
    mt = words.shape[0]
    q, e, bad = t_bk._quantize_rows(xt, block)
    rows = words.transpose(1, 2).reshape(mt * 8, K // 4).contiguous()
    mant = rows.view(torch.int8).reshape(mt * 8, K // block, block)
    assert torch.equal(mant[:M].to(torch.float32), q)
    assert not mant[M:].any()
    ex = exps.transpose(1, 2).reshape(mt * 8, K // block)
    assert torch.equal(ex[:M], torch.where(bad, t_bk.BAD_EXPONENT, e))
    assert not ex[M:].any()
    assert bool(bad.any()) == poison


@pytest.mark.parametrize("M,K,N,block", SERVED_FC[:3] + [(3, 48, 10, 16)])
def test_quantize_activations_matches_jax(exact_jax_exp2, M, K, N, block):
    """Against the JAX package's quantization of x per (row, K-block), where
    its exp2 is exact: mantissas and exponents bit for bit, all-zero blocks
    and rows included."""
    x = _activations(M, K, block, K + N)
    words, exps = t_bk.quantize_activations(torch.from_numpy(x), block)
    jm, je, _ = j_bfp.quantize(jnp.asarray(x), block=block, axis=1)
    mt = words.shape[0]
    mant = (words.transpose(1, 2).reshape(mt * 8, K // 4).contiguous()
            .view(torch.int8).reshape(mt * 8, K // block, block))
    np.testing.assert_array_equal(mant[:M].numpy(), np.asarray(jm))
    ex = exps.transpose(1, 2).reshape(mt * 8, K // block)
    np.testing.assert_array_equal(ex[:M].numpy(), np.asarray(je))


def test_bfp_linear_shrinks_the_block_and_keeps_leading_dims():
    """K = 48 (the reduced fc8): fc_block resolves gcd(48, 32) = 16."""
    assert t_bops.fc_block(48) == j_bops.fc_block(48) == 16
    assert t_bops.fc_block(9216) == 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = rng.standard_normal((48, 10)).astype(np.float32)
    ref = np.asarray(j_bops.bfp_linear(jnp.asarray(x), jnp.asarray(w)))
    got = t_bops.bfp_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (2, 3, 10)
    np.testing.assert_allclose(got.numpy(), ref, **MATMUL_TOL)
    staged = t_bops.quantize_weights(torch.from_numpy(w), block=16)
    assert torch.equal(t_bops.bfp_linear(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         quantized=staged), got)


def test_error_vs_exact_f32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    out = t_bops.bfp_matmul(x, w).numpy()
    ex = t_bref.exact_matmul(x, w).numpy()
    assert np.abs(out - ex).max() / np.abs(ex).max() < 0.05
    assert not np.array_equal(out, ex)


def test_nonfinite_activation_blocks_poison_their_row():
    """A NaN or an infinity in a row's K-block makes that row's outputs
    NaN (the reference leaves the int8 cast of NaN undefined); other rows
    are untouched."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    clean = t_bops.bfp_matmul(torch.from_numpy(x), w).numpy()
    x[0, 5], x[2, 40] = np.nan, np.inf
    got = t_bops.bfp_matmul(torch.from_numpy(x), w).numpy()
    assert np.isnan(got[0]).all() and np.isnan(got[2]).all()
    np.testing.assert_array_equal(got[1], clean[1])


def test_wrapper_checks_shapes_and_refuses_other_devices():
    w = torch.randn(64, 8)
    wq, we = t_bops.quantize_weights(w, block=32)
    with pytest.raises(ValueError, match="unsupported device"):
        t_bk.bfp_matmul(torch.randn(2, 64, device="meta"), wq.to("meta"),
                        we.to("meta"), block=32)
    with pytest.raises(ValueError, match="do not fit"):
        t_bk.bfp_matmul(torch.randn(2, 32), wq, we, block=32)
    with pytest.raises(ValueError, match="do not fit"):
        t_bk.bfp_matmul(torch.randn(2, 64), wq, we, block=16)


@pytest.fixture(scope="module")
def reduced():
    j_cfg = j_get_config("alexnet").reduced()
    np_params = jax.tree_util.tree_map(
        np.asarray, j_alexnet.init(jax.random.PRNGKey(0), j_cfg))
    imgs = np.random.default_rng(0).standard_normal(
        (2, j_cfg.image_size, j_cfg.image_size, j_cfg.in_channels)
    ).astype(np.float32)
    return j_cfg, get_config("alexnet").reduced(), np_params, imgs


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("route", list(ROUTES))
def test_reduced_apply_matches_jax(reduced, exact_jax_exp2, route, flags):
    j_cfg, t_cfg, np_params, imgs = reduced
    change = {**ROUTES[route], **FLAGS[flags]}
    j_cfg = dataclasses.replace(j_cfg, **change)
    t_cfg = dataclasses.replace(t_cfg, **change)
    ref = np.asarray(j_alexnet.apply(np_params, j_cfg, jnp.asarray(imgs)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    got = alexnet.apply(params, t_cfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape == (2, t_cfg.num_classes)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=f"{route} {flags}")
    f32 = alexnet.apply(params, dataclasses.replace(
        t_cfg, fc_bfp=False, conv_bfp=False), torch.from_numpy(imgs))
    assert not np.array_equal(got, f32.numpy())     # the quantization ran


def test_classifier_matches_jax(reduced, exact_jax_exp2):
    j_cfg, t_cfg, np_params, _ = reduced
    feats = np.random.default_rng(7).standard_normal(
        (4, alexnet.fc_input_dim(t_cfg))).astype(np.float32)
    ref = np.asarray(j_alexnet.classifier(
        np_params, dataclasses.replace(j_cfg, fc_bfp=True),
        jnp.asarray(feats)))
    params = alexnet.params_from_numpy(np_params, device="cpu")
    got = alexnet.classifier(params, dataclasses.replace(t_cfg, fc_bfp=True),
                             torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


# XLA's CPU exp2 misses the power of two by at most this, relative
EXP2_REL = 4e-6


def test_jax_exp2_is_inexact_where_the_fixture_patches_it():
    """The reason for ``exact_jax_exp2``: ``jnp.exp2`` of an integer is
    2^n exactly for |n| <= 12, and off by up to EXP2_REL beyond."""
    n = np.arange(-40, 41)
    got = np.asarray(jnp.exp2(jnp.asarray(n, jnp.float32)))
    exact = np.ldexp(np.float32(1), n).astype(np.float32)
    small = np.abs(n) <= 12
    np.testing.assert_array_equal(got[small], exact[small])
    assert (got[~small] != exact[~small]).any()
    np.testing.assert_allclose(got, exact, rtol=EXP2_REL, atol=0)


def _near_ties(v, block, axis):
    """Quantize ``v`` along ``axis`` as the port does -> (|mantissas|,
    exponents, mask of elements whose scaled value lies within EXP2_REL of
    a half-step tie: the only ones an inexact scale can round the other
    way, by one step)."""
    m, e, _ = t_bfp.quantize(torch.from_numpy(v), block=block, axis=axis)
    e = e.numpy().astype(np.int64)
    vb = np.moveaxis(v.astype(np.float64), axis % v.ndim, -1)
    vb = vb.reshape(*vb.shape[:-1], -1, block)
    scaled = vb * np.ldexp(1.0, 7 - np.moveaxis(e, axis % v.ndim, -1))[
        ..., None]
    near = (np.abs(np.abs(scaled - np.floor(scaled)) - 0.5)
            <= EXP2_REL * np.abs(scaled))
    near = np.moveaxis(near.reshape(*near.shape[:-2], -1), -1,
                       axis % v.ndim).reshape(m.shape)
    return np.abs(m.numpy().astype(np.float64)), e, near


def _bfp_fc_bound(x, w, ref, block):
    """Per-output bound on |port - unpatched JAX| for one FC layer: one
    quantization step for each activation or weight element near a
    half-step tie (an exp2 off by EXP2_REL can round it the other way),
    the rescale off by EXP2_REL, and the JAX package's own summation
    tolerance."""
    mx, ex, near_x = _near_ties(x, block, 1)        # (M, KB, blk)
    mw, ew, near_w = _near_ties(w, block, 0)        # (KB, blk, N)
    s = np.ldexp(1.0, ex[:, :, None] + ew[None] - 14)   # (M, KB, N)
    steps = (np.einsum("mkb,kbn->mkn", near_x, mw + near_w)
             + np.einsum("mkb,kbn->mkn", mx, near_w))
    dots = np.einsum("mkb,kbn->mkn", mx, mw)
    bound = (s * (steps + EXP2_REL * dots)).sum(axis=1)
    return bound + MATMUL_TOL["atol"] + MATMUL_TOL["rtol"] * np.abs(ref)


@pytest.mark.parametrize("flags", ["fc", "both"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_unpatched_jax_fc_layers_within_one_step(reduced, route, flags):
    """fc6-fc8 of the unpatched JAX kernel on the model's own activations
    (the port's features, then its fc chain) against the port: the weight
    streams within one mantissa step, each layer within the bound of one
    step per element near a half-step tie."""
    _, t_cfg, np_params, imgs = reduced
    cfg = dataclasses.replace(t_cfg, **ROUTES[route], **FLAGS[flags])
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = alexnet.features(params, cfg, torch.from_numpy(imgs)).numpy()
    for j in range(len(cfg.fc_dims)):
        name = f"fc{j + 6}"
        w = np.array(np_params[name]["w"])
        block = t_bops.fc_block(w.shape[0])
        jm, je = j_bk.quantize_weights(jnp.asarray(w), block=block)
        wq, we = t_bops.quantize_weights(torch.from_numpy(w), block=block)
        np.testing.assert_array_equal(we.numpy(), np.asarray(je))
        dm = (t_bk.reference_layout(wq, block).numpy().astype(np.int32)
              - np.asarray(jm).astype(np.int32))
        assert np.abs(dm).max() <= 1
        ref = np.asarray(j_bops.bfp_matmul(jnp.asarray(x), jnp.asarray(w),
                                           block=block, interpret=True))
        got = t_bops.bfp_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                block=block).numpy()
        bound = _bfp_fc_bound(x, w, ref, block)
        assert (np.abs(got - ref) <= bound).all(), f"{name} {route} {flags}"
        x = got + np_params[name]["b"]
        if j < len(cfg.fc_dims) - 1:
            x = np.maximum(x, 0)


def _slab_inputs(kw, c_in, c_out, seed=0):
    k, g = kw["kernel"], kw.get("groups", 1)
    return (np.random.default_rng(seed).standard_normal(
        (k, k, c_in // g, c_out)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name,kw,H,c_in,c_out", LAYERS)
def test_conv_bfp_slabs_match_jax(exact_jax_exp2, name, kw, H, c_in, c_out):
    """conv_bfp slabs on the kernel route: the direct kernel's slab is a
    re-layout, so its quantization is bit-equal; a Winograd slab quantizes
    G w G^T tiles that already differ by up to 1e-6, so an element may sit
    one quantization step 2^(e-7) away."""
    w = _slab_inputs(kw, c_in, c_out)
    shape = (2, H, H, c_in)
    ref = j_conv.pack_conv_weights(j_conv.ConvSpec(route="pallas", **kw),
                                   shape, jnp.asarray(w), bfp_pack=True)
    got = t_conv.pack_conv_weights(t_conv.ConvSpec(route="pallas", **kw),
                                   shape, torch.from_numpy(w), bfp_pack=True)
    assert got.bfp and ref.bfp
    assert got.kernel == ref.kernel.replace("pallas-", "cuda-")
    want, have = np.asarray(ref.data), got.data.numpy()
    assert have.shape == want.shape
    plain = t_conv.pack_conv_weights(t_conv.ConvSpec(route="pallas", **kw),
                                     shape, torch.from_numpy(w)).data
    assert not torch.equal(got.data, plain)
    if got.kernel == "cuda-direct":
        np.testing.assert_array_equal(have, want)
        return
    cb = have.shape[-2]
    _, e, _ = t_bfp.quantize(plain, block=np.gcd(cb, 32), axis=-2)
    step = t_bfp.pow2(e.to(torch.int32) - 7).numpy()
    step = np.repeat(step, np.gcd(cb, 32), axis=-2)
    assert (np.abs(have - want) <= step).all()


@pytest.mark.parametrize("name,kw,H,c_in,c_out", LAYERS)
def test_unpatched_jax_conv_bfp_slabs_within_one_step(name, kw, H, c_in,
                                                      c_out):
    """The unpatched JAX package's conv_bfp slabs sit within one
    quantization step 2^(e-7) of the port's, element by element."""
    w = _slab_inputs(kw, c_in, c_out)
    shape = (2, H, H, c_in)
    ref = j_conv.pack_conv_weights(j_conv.ConvSpec(route="pallas", **kw),
                                   shape, jnp.asarray(w), bfp_pack=True)
    got = t_conv.pack_conv_weights(t_conv.ConvSpec(route="pallas", **kw),
                                   shape, torch.from_numpy(w), bfp_pack=True)
    _, e, _ = t_bfp.quantize(got.data, block=np.gcd(got.data.shape[-2], 32),
                             axis=-2)
    step = np.repeat(t_bfp.pow2(e.to(torch.int32) - 7).numpy(),
                     np.gcd(got.data.shape[-2], 32), axis=-2)
    assert (np.abs(got.data.numpy() - np.asarray(ref.data)) <= step).all()


@pytest.mark.parametrize("route", ["direct", "winograd"])
def test_conv_bfp_quantizes_raw_filters_off_the_kernel_route(route):
    """The routes without a packed slab quantize the raw filters along
    C/g, block gcd(C/g, 32), bit-equal to the JAX package."""
    name, kw, H, c_in, c_out = LAYERS[3]
    w = _slab_inputs(kw, c_in, c_out, seed=2)
    ref = j_conv.pack_conv_weights(j_conv.ConvSpec(route=route, **kw),
                                   (2, H, H, c_in), jnp.asarray(w),
                                   bfp_pack=True)
    got = t_conv.pack_conv_weights(t_conv.ConvSpec(route=route, **kw),
                                   (2, H, H, c_in), torch.from_numpy(w),
                                   bfp_pack=True)
    assert got.kernel == ref.kernel == route and got.bfp
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))


def test_staged_fc_streams_are_bit_equal(reduced):
    """fc6's stream staged by conv5's hook, all three staged by
    pack_serving_slabs, and the unstaged classifier give the same bits."""
    _, t_cfg, np_params, imgs = reduced
    cfg = dataclasses.replace(t_cfg, use_pallas=True, fc_bfp=True)
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(imgs)
    feats = alexnet.features(params, cfg, x)
    unstaged = alexnet.classifier(params, cfg, feats)
    stager = WeightStager()
    staged = alexnet.apply(params, cfg, x, stager=stager)
    assert stager.get("fc6") is not None
    assert torch.equal(staged, unstaged)
    packed = alexnet.pack_serving_slabs(params, cfg, x.shape[0])
    for name in ("fc6", "fc7", "fc8"):
        w = params[name]["w"]
        ref = t_bops.quantize_weights(w, block=t_bops.fc_block(w.shape[0]))
        assert all(torch.equal(a, r) for a, r in zip(packed[name], ref))
    assert torch.equal(alexnet.apply(params, cfg, x, packed=packed),
                       unstaged)


def test_stale_bfp_slab_is_repacked_not_dropped():
    """A bfp slab that misses the plan (another input shape, or a deferred
    bias) is repacked quantized for the actual call."""
    spec = t_conv.ConvSpec(kernel=3, relu=True, fuse_pool=True,
                           route="pallas")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 13, 13, 8)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 8)) * 0.3).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    fresh = t_conv.pack_conv_weights(spec, tuple(x.shape), w, bfp_pack=True)
    want = t_conv.dispatch_conv(spec, x, w, b, w_packed=fresh)
    plain = t_conv.dispatch_conv(spec, x, w, b)
    assert not torch.equal(want, plain)
    stale = t_conv.pack_conv_weights(spec, tuple(x.shape), w, bfp_pack=True,
                                     plan=t_conv.ConvPlan(c_block=4))
    assert stale.data.shape != fresh.data.shape
    assert torch.equal(t_conv.dispatch_conv(spec, x, w, b, w_packed=stale),
                       want)
    spec_d = dataclasses.replace(spec, fuse_bias=False)
    out_d = t_conv.dispatch_conv(spec_d, x, w, b, w_packed=fresh)
    assert not torch.equal(out_d, t_conv.dispatch_conv(spec_d, x, w, b))
    # a route fallback quantizes the raw filters instead
    direct = t_conv.dispatch_conv(spec.with_route("direct"), x, w, b,
                                  w_packed=fresh)
    assert not torch.equal(direct, t_conv.dispatch_conv(
        spec.with_route("direct"), x, w, b))


def test_shared_stager_never_serves_another_quantization(reduced):
    """One stager shared by an f32 config and a conv_bfp config keeps one
    slab per quantization: each config's staged forward equals its fresh
    forward."""
    _, t_cfg, np_params, imgs = reduced
    params = alexnet.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(imgs)
    f32 = dataclasses.replace(t_cfg, use_pallas=True)
    q = dataclasses.replace(f32, conv_bfp=True)
    stager = WeightStager()
    for cfg in (f32, q, f32, q):
        assert torch.equal(alexnet.apply(params, cfg, x, stager=stager),
                           alexnet.apply(params, cfg, x))
    assert stager.misses == 10


def test_engine_serves_the_bfp_config_on_the_cpu():
    """CnnEngine with fc_bfp and conv_bfp: served logits bit-equal to apply
    at the served bucket; every bucket shares one copy of the FC streams;
    the degrade twin keeps both flags."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              use_pallas=True, fc_bfp=True, conv_bfp=True)
    params = alexnet.init(0, cfg, device="cpu")
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=4), params=params,
                    device="cpu")
    assert eng._cfg_direct.fc_bfp and eng._cfg_direct.conv_bfp
    imgs = np.random.default_rng(9).standard_normal(
        (4, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
        np.float32)
    reqs = [ImageRequest(image=im) for im in imgs]
    for group in (reqs[:3], reqs[3:]):
        for r in group:
            eng.submit(r)
        eng.run_until_done()
    assert [r.served_bucket for r in reqs] == [4, 4, 4, 1]
    for r in reqs:
        x = np.zeros((r.served_bucket, *imgs.shape[1:]), np.float32)
        rows = reqs[:3] if r.served_bucket == 4 else reqs[3:]
        for i, q in enumerate(rows):
            x[i] = q.image
        ref = alexnet.apply(params, cfg, torch.from_numpy(x)).numpy()
        assert np.array_equal(r.logits, ref[r.served_row])
    for name in ("fc6", "fc7", "fc8"):
        assert eng._slabs(1)[name] is eng._slabs(4)[name]
        assert eng._slabs_direct(2)[name] is eng._slabs(4)[name]
