"""Kernel 5's entry (decode attention) on the CPU against the JAX package.

On a CPU tensor the port's ``decode_attention`` runs its plain version; it
is held against the reference's Pallas kernel in interpret mode
(``kernels/decode_attn/ops.decode_attention(pallas=True)``) and against the
grouped einsum its models call (``nn/flash.decode_attention``), on the same
numpy-made inputs.  Tolerance: rtol = atol = 1e-5 in f32 and 5e-2 in bf16,
the reference's own bounds for its kernel (``tests/test_kernels.py``).
The plain version with f32 probabilities, against which the card tests
hold the kernel in bf16 within one bf16 step, is held to that same gate
against the reference's kernel, which keeps its probabilities in f32 too.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.kernels.decode_attn import ops as j_ops
from repro.nn import flash as j_flash
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.decode_attn import ops
from repro_torch.kernels.decode_attn.ref import decode_attention_f32_ref
from repro_torch.nn import flash

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}

# the reference's sweep, a group of 3 (smollm-360m's and llama3.2-3b's G)
# and D = 64 (smollm-360m's head dim); MHA (G = 1) at whisper-tiny's D = 64
# over 150 encoder rows and at phi-3-vision-4.2b's D = 96
GEOMETRIES = [(3, 64, 4, 2, 16), (2, 100, 8, 8, 32), (1, 33, 6, 3, 8),
              (2, 40, 6, 2, 16), (2, 96, 15, 5, 64), (2, 150, 6, 6, 64),
              (2, 72, 4, 4, 96)]


def _inputs(seed, B, S, H, KV, D, dtype):
    """numpy inputs rounded to ``dtype`` once, so both sides see the same
    values: q, k, v and lengths in [1, S] that include S."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
            for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))]
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    lens[0] = S
    return arrs, lens


def _torch(a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to(DTYPES[dtype][1])


def _port(arrs, lens, dtype, **kw):
    q, k, v = (_torch(a, dtype) for a in arrs)
    out = ops.decode_attention(q, k, v, torch.as_tensor(lens), **kw)
    assert out.dtype == DTYPES[dtype][1] and out.shape == q.shape
    return out.float().numpy()


def _close(got, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D", GEOMETRIES)
def test_decode_attention_matches_reference(B, S, H, KV, D, dtype):
    arrs, lens = _inputs(B * S + D, B, S, H, KV, D, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    got = _port(arrs, lens, dtype)
    _close(got, j_ops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                       pallas=True, interpret=True), dtype)
    _close(got, j_flash.decode_attention(jq, jk, jv, jnp.asarray(lens)),
           dtype)


@pytest.mark.parametrize("B,S,H,KV,D", GEOMETRIES)
def test_f32_probability_version_matches_reference_kernel(B, S, H, KV, D):
    """In bf16 the two differ only in their rounding of the output: within
    atol 1e-4 + rtol 1e-2 (a bf16 step is at most 2**-7 relative)."""
    arrs, lens = _inputs(B * S + D, B, S, H, KV, D, "bfloat16")
    q, k, v = (_torch(a, "bfloat16") for a in arrs)
    got = decode_attention_f32_ref(q, k, v, torch.as_tensor(lens))
    assert got.dtype == torch.bfloat16
    ref = j_ops.decode_attention(*(jnp.asarray(a) for a in arrs),
                                 jnp.asarray(lens), pallas=True,
                                 interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scalar_length_broadcasts(dtype):
    arrs, _ = _inputs(3, 3, 40, 6, 2, 16, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    q, k, v = (_torch(a, dtype) for a in arrs)
    got = ops.decode_attention(q, k, v, 17).float().numpy()
    _close(got, j_ops.decode_attention(jq, jk, jv, 17, pallas=True,
                                       interpret=True), dtype)
    _close(got, flash.decode_attention(q, k, v, torch.tensor(17))
           .float().numpy(), dtype)


def test_length_zero_is_the_mean_of_v():
    """Every score masked alike: the reference's softmax is uniform, and
    the port's plain version and kernel give the mean of v over S."""
    arrs, _ = _inputs(4, 2, 24, 6, 2, 16, "float32")
    lens = np.array([0, 5], np.int32)
    got = _port(arrs, lens, "float32")
    ref = j_flash.decode_attention(*(jnp.asarray(a) for a in arrs),
                                   jnp.asarray(lens))
    _close(got, ref, "float32")
    mean_v = arrs[2][0].mean(axis=0).repeat(3, axis=0)
    np.testing.assert_allclose(got[0, 0], mean_v, rtol=1e-5, atol=1e-6)


def test_prescale_rounds_the_factor_in_q_dtype():
    """For D = 128 under bf16 the reference multiplies by D**-0.5 rounded to
    bf16 (a weakly typed scalar); the port does the same."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 1, 2, 128)).astype(ml_dtypes.bfloat16)
    ref = np.asarray(jnp.asarray(q) * (128 ** -0.5)).astype(np.float32)
    got = decode_attn.prescale(_torch(q, "bfloat16")).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_plain_version_does_not_count_launches():
    arrs, lens = _inputs(1, 2, 16, 4, 2, 8, "float32")
    ops.reset_launch_counts()
    _port(arrs, lens, "float32")
    _port(arrs, lens, "float32", pallas=False)
    assert ops.launch_counts() == {"decode_attn": 0}


@pytest.mark.parametrize("shapes", [
    ((2, 1, 5, 8), (2, 10, 2, 8)),      # H % KV != 0
    ((2, 2, 4, 8), (2, 10, 2, 8)),      # two query tokens
    ((2, 1, 4, 8), (3, 10, 2, 8)),      # batch mismatch
    ((2, 1, 4, 8), (2, 10, 2, 16)),     # head-dim mismatch
])
def test_bad_shapes_raise(shapes):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match="decode_attention"):
        decode_attn.decode_attention(q, k, k, torch.ones(qs[0],
                                                         dtype=torch.int32))


# kernel 5's launch geometry (the split over cache rows), at smollm-360m's
# and llama3.2-3b's decode shapes and at off-path ones
SPLIT_SHAPES = [(8, 512, 5, 3, 64), (8, 2048, 8, 3, 128), (4, 300, 2, 3, 64),
                (1, 33, 3, 2, 8), (2, 100, 8, 1, 32), (16, 4096, 8, 4, 128)]


@pytest.mark.parametrize("B,S,KV,G,D", SPLIT_SHAPES)
def test_every_valid_row_lies_in_exactly_one_split(B, S, KV, G, D):
    """The rows each split reads, as the kernel bounds them, tile [0, n)
    without overlap for every kind of length (0: all S rows; past S: S),
    and the merge's ceil(n / R) splits fit the grid."""
    R = decode_attn.split_rows(B, S, KV, G, D)
    splits = decode_attn.decode_grid(B, S, KV, G, D)[0]
    assert splits == -(-S // R)
    for length in sorted({0, 1, R - 1, R, R + 1, 2 * R + 1, S - 1, S,
                          S + 7}):
        n = S if length <= 0 else min(length, S)
        bounds = decode_attn.split_bounds(length, S, R)
        assert len(bounds) == -(-n // R) <= splits
        covered = [r for lo, hi in bounds for r in range(lo, hi)]
        assert covered == list(range(n))
        assert all(lo == i * R and 0 < hi - lo <= R
                   for i, (lo, hi) in enumerate(bounds))


@pytest.mark.parametrize("B,S,KV,G,D", SPLIT_SHAPES)
def test_split_rows_is_a_tile_multiple_picked_from_the_shape(B, S, KV, G, D):
    R = decode_attn.split_rows(B, S, KV, G, D)
    assert R % decode_attn.TILE_ROWS == 0
    assert decode_attn.TILE_ROWS <= R <= decode_attn.MAX_SPLIT_ROWS
    assert R & (R - 1) == 0
    assert decode_attn.scratch_shape(B, S, KV, G, D) == (
        B, KV, decode_attn.decode_grid(B, S, KV, G, D)[0], G, D + 2)


@pytest.mark.parametrize("S", [32768, 65536, 100000])
def test_a_long_cache_keeps_the_merge_within_its_splits(S):
    """Past 128 splits of 256 rows the split widens, so the merge takes
    every split of a slot."""
    R = decode_attn.split_rows(1, S, 8, 4, 128)
    assert -(-S // R) <= decode_attn.MAX_SPLITS
    assert R % decode_attn.TILE_ROWS == 0 and R & (R - 1) == 0


@pytest.mark.parametrize("name,B,S,KV,G,D", [
    ("smollm-360m", 8, 512, 5, 3, 64), ("llama3.2-3b", 8, 2048, 8, 3, 128)])
def test_served_geometries_launch_at_least_one_wave(name, B, S, KV, G, D):
    """At least 132 blocks (the H100's SMs) at both decode geometries of
    ``chip_smoke.py`` phase 5, so a long slot spreads over the card."""
    grid = decode_attn.decode_grid(B, S, KV, G, D)
    assert grid[1:] == (KV * -(-G // decode_attn.HEADS_PER_BLOCK), B)
    assert np.prod(grid) >= 132, (name, grid)
