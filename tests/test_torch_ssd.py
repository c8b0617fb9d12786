"""Kernels 6 and 7's entries and the Mamba-2 mixer on the CPU against the
JAX package.

On a CPU tensor the port's kernel entries run their plain versions; they
are held against the reference's Pallas kernels in interpret mode
(``ssd_chunked_pallas``, ``conv1d_depthwise_causal``), against its oracles
(``ssd_reference``, ``conv1d_depthwise_causal_ref``) and, for the mixer,
against ``repro.nn.ssd`` on the reduced mamba2-2.7b config, all on the
same numpy-made inputs.  Tolerances: kernel entries against the reference's
kernels rtol = atol = 1e-5 in f32 (both f32 inside, summed in other
orders); in bf16, y within one bf16 step (rtol 2**-7, atol 1e-5 of the
largest |y|: both round f32 values that differ by f32 noise to bf16) and
the f32 state at 1e-5.  Against the token-by-token recurrence 1e-4 (a
different algorithm); the mixer 1e-4, caches included.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.core import winograd as j_wg
from repro.kernels.conv import ref as j_conv_ref
from repro.kernels.conv import winograd as j_conv_k
from repro.kernels.ssd import ref as j_ssd_ref
from repro.kernels.ssd import ssd as j_ssd_k
from repro.nn import ssd as j_nn_ssd
from repro_torch.configs import get_config
from repro_torch.core import winograd as wg
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv import ref as conv_ref
from repro_torch.kernels.conv import winograd as conv_k
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_k
from repro_torch.nn import ssd as nn_ssd

BF16_STEP = 2.0 ** -7

# (L, H, P, G, N, chunk): the reference's kernel sweep
# (tests/test_kernels.py), a ragged tail of three chunks, and mamba2-2.7b's
# head geometry over two 256-token chunks
SSD_GEOMETRIES = [(64, 4, 8, 2, 16, 16), (100, 2, 4, 1, 8, 32),
                  (16, 8, 16, 1, 4, 16), (37, 4, 8, 2, 8, 16),
                  (300, 2, 64, 1, 128, 256)]


def _ssd_inputs(seed, L, H, P, G, N, dtype, B=2):
    """numpy inputs rounded to ``dtype`` once (dt and A stay f32, as the
    models give them), as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
            for shape in ((B, L, H, P), (B, L, G, N), (B, L, G, N))]
    dt = rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32)
    x, Bm, Cm = arrs
    jax_in = (jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
              jnp.asarray(Bm), jnp.asarray(Cm))
    tdt = getattr(torch, dtype)
    torch_in = (torch.from_numpy(x.astype(np.float32)).to(tdt),
                torch.from_numpy(dt), torch.from_numpy(A),
                torch.from_numpy(Bm.astype(np.float32)).to(tdt),
                torch.from_numpy(Cm.astype(np.float32)).to(tdt))
    return jax_in, torch_in


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, np.float32), np.float32)


def _close(got, ref, tol):
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)


def _one_step(got, ref):
    """Within one bf16 step of ``ref`` (plus 1e-5 of its largest value)."""
    got, ref = _f32(got), _f32(ref)
    np.testing.assert_allclose(got, ref, rtol=BF16_STEP,
                               atol=1e-5 * np.abs(ref).max())


# --- kernel 6 -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,H,P,G,N,chunk", SSD_GEOMETRIES)
def test_ssd_entry_matches_pallas_kernel(L, H, P, G, N, chunk, dtype):
    j_in, t_in = _ssd_inputs(L + H, L, H, P, G, N, dtype)
    y_ref, s_ref = j_ssd_k.ssd_chunked_pallas(*j_in, chunk=chunk,
                                              interpret=True)
    ssd_ops.reset_launch_counts()
    y, s = ssd_ops.ssd_chunked(*t_in, chunk=chunk)
    assert ssd_ops.launch_counts() == {"ssd": 0}        # plain on the CPU
    assert y.dtype == t_in[0].dtype and s.dtype == torch.float32
    assert tuple(y.shape) == (2, L, H, P) and tuple(s.shape) == (2, H, N, P)
    if dtype == "float32":
        _close(y, y_ref, 1e-5)
    else:
        _one_step(y, y_ref)
    _close(s, s_ref, 1e-5)


@pytest.mark.parametrize("L,H,P,G,N,chunk", SSD_GEOMETRIES[:4])
def test_ssd_entry_matches_recurrence(L, H, P, G, N, chunk):
    """Against the reference's token-by-token oracle, and the port's own
    oracle against it."""
    j_in, t_in = _ssd_inputs(L * 3, L, H, P, G, N, "float32")
    y_ref, s_ref = j_ssd_ref.ssd_reference(*j_in)
    y, s = ssd_k.ssd_chunked_pallas(*t_in, chunk=chunk)
    _close(y, y_ref, 1e-4)
    _close(s, s_ref, 1e-4)
    y_o, s_o = ssd_ref.ssd_reference(*t_in)
    _close(y_o, y_ref, 1e-5)
    _close(s_o, s_ref, 1e-5)


@pytest.mark.parametrize("L,chunk", [(37, 16), (100, 32), (5, 256)])
def test_ssd_padding_leaves_final_state_unchanged(L, chunk):
    """Rows past L are zeros with dt = 0: the same inputs padded by hand
    to a whole number of chunks give the same final state and the same y
    on the real rows, and so does one unchunked pass."""
    _, (x, dt, A, Bm, Cm) = _ssd_inputs(L, L, 4, 8, 2, 8, "float32")
    y, s = ssd_k.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)
    pad = (-L) % min(chunk, L) + chunk
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
              for t in (x, dt, Bm, Cm)]
    y_p, s_p = ssd_k.ssd_chunked_plain(padded[0], padded[1], A, padded[2],
                                       padded[3], chunk=min(chunk, L))
    assert torch.equal(s_p, s)
    assert torch.equal(y_p[:, :L], y)
    _, s_one = ssd_k.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=L)
    _close(s_one, s, 1e-5)


def test_ssd_entry_pallas_false_is_the_jnp_twin():
    """``pallas=False`` runs the port of ``nn.ssd.ssd_chunked``, which
    matches the reference's twin, in bf16 too (its roundings to x's dtype
    are the reference's)."""
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        j_in, t_in = _ssd_inputs(9, 48, 4, 8, 2, 16, dtype)
        y_ref, s_ref = j_nn_ssd.ssd_chunked(*j_in, 16)
        y, s = ssd_ops.ssd_chunked(*t_in, chunk=16, pallas=False)
        assert y.dtype == t_in[0].dtype
        _close(y, y_ref, tol)
        _close(s, s_ref, 1e-5 if dtype == "float32" else tol)


def test_ssd_entry_refuses_gradients():
    """Kernel 6 has no backward yet (ROADMAP item 7d): an input that
    requires grad raises instead of leaving the graph; without grad mode,
    and on the pure-torch route, it runs."""
    _, t_in = _ssd_inputs(4, 24, 4, 8, 2, 8, "float32")
    for t in t_in:
        t.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="item 7d"):
            ssd_ops.ssd_chunked(*t_in, chunk=8)
        t.requires_grad_(False)
    x = t_in[0].requires_grad_(True)
    with torch.no_grad():
        ssd_ops.ssd_chunked(*t_in, chunk=8)
    y, _ = ssd_ops.ssd_chunked(*t_in, chunk=8, pallas=False)
    y.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


# the staged twin of kernel 6 (its five stages in PyTorch): the file's
# geometries and L = 1
STAGED_GEOMETRIES = SSD_GEOMETRIES + [(1, 4, 64, 1, 128, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,H,P,G,N,chunk", STAGED_GEOMETRIES)
def test_ssd_staged_twin_matches_plain_and_pallas_kernel(L, H, P, G, N,
                                                         chunk, dtype):
    """Decays, C.B^T once per group, each chunk's dS, the state pass and y
    from the state entering each chunk give the plain version's function
    (both f32 inside, 1e-5) and the reference kernel's (in bf16 y within
    one bf16 step)."""
    j_in, t_in = _ssd_inputs(L + 2 * H, L, H, P, G, N, dtype)
    y, s = ssd_k.ssd_chunked_staged(*t_in, chunk=chunk)
    y_p, s_p = ssd_k.ssd_chunked_plain(*t_in, chunk=chunk)
    assert y.dtype == t_in[0].dtype and s.dtype == torch.float32
    assert y.shape == y_p.shape and s.shape == s_p.shape
    if dtype == "float32":
        _close(y, y_p, 1e-5)
    else:
        _one_step(y, y_p)
    _close(s, s_p, 1e-5)
    y_ref, s_ref = j_ssd_k.ssd_chunked_pallas(*j_in, chunk=chunk,
                                              interpret=True)
    if dtype == "float32":
        _close(y, y_ref, 1e-5)
    else:
        _one_step(y, y_ref)
    _close(s, s_ref, 1e-5)


# (B, L, H, P, G, N, chunk): the card cases of tests/test_torch_cuda.py,
# and mamba2-2.7b's heads at the served lengths and a long prompt;
# jamba-v0.1-52b's (N = 16) at the same lengths
SSD_CARD_SHAPES = [(1, 200, 80, 64, 1, 128, 256), (1, 600, 8, 64, 1, 128, 256),
                   (2, 100, 4, 8, 2, 16, 32), (2, 37, 6, 16, 3, 32, 16),
                   (1, 1, 4, 64, 1, 128, 256), (2, 300, 4, 64, 2, 256, 128),
                   (2, 64, 4, 8, 2, 16, 16), (2, 16, 8, 16, 1, 4, 16),
                   (1, 472, 80, 64, 1, 128, 256),
                   (1, 2048, 80, 64, 1, 128, 256),
                   (1, 200, 128, 64, 1, 16, 256),
                   (1, 2048, 128, 64, 1, 16, 256)]


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CARD_SHAPES)
def test_ssd_launch_geometry_and_scratch(B, L, H, P, G, N, chunk):
    """Every launch of every tile setting the kernel accepts fits CUDA's
    limits (blocks, 1024 threads, 227 KB of shared memory); with one chunk
    the state slice is the row tile; the scratch is its parts, each
    64-word aligned but the last."""
    Q = min(chunk, L)
    nc = ssd_k.chunks(L, Q)
    rows, nslice = ssd_k.row_tile(B, L, H, Q), ssd_k.state_slice(B, L, H,
                                                                 N, Q)
    assert rows in ssd_k.ROW_TILES and nslice in ssd_k.STATE_SLICES
    assert nc > 1 or nslice == rows
    for rt in ssd_k.ROW_TILES:
        for ns in (ssd_k.STATE_SLICES if nc > 1 else (rt,)):
            grids = ssd_k.ssd_grids(B, L, H, P, G, N, Q, rt, ns)
            assert set(grids) == ({"cb", "front"} if nc == 1
                                  else {"front", "pass", "y"})
            for blocks, threads in grids.values():
                assert 1 <= blocks <= ssd_k.MAX_GRID and threads <= 1024
            for itemsize in (2, 4):
                smem = ssd_k.smem_bytes(L, Q, itemsize, rt, ns)
                assert max(smem.values()) <= ssd_k.MAX_SMEM
    parts = ssd_k.scratch_parts(B, L, H, P, G, N, Q)
    Qp = ssd_k.padded_chunk(Q)
    assert Qp % ssd_k.CB_TILE == 0 and Q <= Qp < Q + ssd_k.CB_TILE
    assert parts["lam"] % 64 == 0 and parts["cb"] % 64 == 0
    assert parts["cb"] >= B * G * nc * Qp * Qp
    assert parts["states"] == (B * H * nc * N * P if nc > 1 else 0)
    assert ssd_k.scratch_numel(B, L, H, P, G, N, Q) == sum(parts.values())


@pytest.mark.parametrize("L,nslice", [(200, 64), (472, 32), (2048, 64)])
def test_ssd_tiles_at_jamba_heads(L, nslice):
    """jamba-v0.1-52b's 128 heads at N = 16: 64-row tiles, and state slices
    of 64 rows (32 where two chunks give 256 state blocks, under
    MIN_BLOCKS), more than N, so a state block masks the rows past N."""
    Q = min(256, L)
    assert ssd_k.row_tile(1, L, 128, Q) == 64
    assert ssd_k.state_slice(1, L, 128, 16, Q) == nslice > 16


def test_ssd_scratch_at_a_served_prefill():
    """A 472-token prefill of mamba2-2.7b (two chunks) needs about 6 MB of
    f32 scratch: C.B^T 0.5 MB, the states 5.2 MB."""
    words = ssd_k.scratch_numel(1, 472, 80, 64, 1, 128, 256)
    assert 5e6 < 4 * words < 7e6


@pytest.mark.parametrize("L,rows,nslice", [(200, 64, 64), (472, 64, 64),
                                           (2048, 64, 64), (16, 32, 32),
                                           (1, 32, 32)])
def test_ssd_tile_rules(L, rows, nslice):
    """mamba2-2.7b's heads: 64-row tiles at the served and long lengths,
    32 where 64 would leave the launch under MIN_BLOCKS blocks."""
    Q = min(256, L)
    assert ssd_k.row_tile(1, L, 80 if L > 16 else 4, Q) == rows
    assert ssd_k.state_slice(1, L, 80 if L > 16 else 4, 128, Q) == nslice


def _cb_tiles_written(Qp, tr):
    """The (rows, keys) C.B^T tiles the kernel writes, in its block order."""
    out = []
    for idx in range(ssd_k.cb_tiles(Qp, tr)):
        t, ti = idx, 0
        while t >= ti * tr // ssd_k.CB_TILE + 1:
            t -= ti * tr // ssd_k.CB_TILE + 1
            ti += 1
        out.append((ti, t))
    return out


@pytest.mark.parametrize("Q", [1, 37, 64, 200, 256])
@pytest.mark.parametrize("tr", [32, 64])
def test_ssd_cb_tiles_cover_every_read(Q, tr):
    """Every C.B^T entry a y block reads (rows [i0, i0 + rows), keys in
    32-key steps below min(i0 + rows, Q)) lies in a written tile, for every
    row tile and C.B^T tile height; no tile is written twice."""
    Qp = ssd_k.padded_chunk(Q)
    tiles = _cb_tiles_written(Qp, tr)
    assert len(set(tiles)) == len(tiles)
    written = np.zeros((Qp, Qp), bool)
    for ti, tk in tiles:
        written[ti * tr:(ti + 1) * tr,
                tk * ssd_k.CB_TILE:(tk + 1) * ssd_k.CB_TILE] = True
    for rows in ssd_k.ROW_TILES:
        for i0 in range(0, Q, rows):
            kend = min(i0 + rows, Q)
            steps = -(-kend // ssd_k.KEY_STEP)
            assert written[i0:i0 + rows, :steps * ssd_k.KEY_STEP].all()


# --- kernel 7 -----------------------------------------------------------------
# (L, C, r): the reference's sweep (tests/test_kernels.py) and the
# served widths' ragged tail (L = 200 is no multiple of 3)
DW1D_CASES = [(64, 8, 4), (100, 16, 3), (33, 5, 4), (7, 128, 4),
              (200, 96, 4)]


def _dw1d_inputs(seed, L, C, r, dtype, B=2):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, L, C)),
                               getattr(jnp, dtype)))
    w = rng.standard_normal((r, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    t_x = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    return ((jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
            (t_x, torch.from_numpy(w), torch.from_numpy(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,C,r", DW1D_CASES)
def test_dw1d_entry_matches_pallas_kernel(L, C, r, dtype):
    """f32 weights and bias, as the models hold them; x in f32 or bf16."""
    (jx, jw, jb), (x, w, b) = _dw1d_inputs(L * 7 + C, L, C, r, dtype)
    ref = j_conv_k.conv1d_depthwise_causal(jx, jw, jb, interpret=True)
    conv_ops.reset_launch_counts()
    got = conv_ops.conv1d_depthwise_causal(x, w, b)
    assert conv_ops.launch_counts()["dw1d"] == 0      # plain on the CPU
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "float32":
        _close(got, ref, 1e-5)
    else:
        _one_step(got, ref)
    # no bias: the kernel's zeros
    ref0 = j_conv_k.conv1d_depthwise_causal(jx, jw, None, interpret=True)
    got0 = conv_k.conv1d_depthwise_causal(x, w)
    if dtype == "float32":
        _close(got0, ref0, 1e-5)


@pytest.mark.parametrize("L,C,r", DW1D_CASES)
def test_dw1d_matches_direct_oracle(L, C, r):
    """The plain Winograd (f32) and the port's direct oracle against the
    reference's direct oracle; the pure-torch Winograd twin against the
    reference's (``core/winograd``) in x's dtype."""
    (jx, jw, jb), (x, w, b) = _dw1d_inputs(L + C, L, C, r, "float32")
    ref = j_conv_ref.conv1d_depthwise_causal_ref(jx, jw, jb)
    _close(conv_k.conv1d_depthwise_causal_plain(x, w, b), ref, 1e-4)
    _close(conv_ref.conv1d_depthwise_causal_ref(x, w, b), ref, 1e-5)
    _close(wg.conv1d_depthwise_causal(x, w, b),
           j_wg.conv1d_depthwise_causal(jx, jw, jb), 1e-5)
    _close(conv_ops.conv1d_depthwise_causal(x, w, b, pallas=False),
           j_wg.conv1d_depthwise_causal(jx, jw, jb), 1e-5)


@pytest.mark.parametrize("B,L,C,tiles",
                         [(1, 200, 5120, 4), (1, 2048, 5120, 4),
                          (1, 472, 5120, 4), (2, 33, 5, 1), (1, 2, 130, 1)])
def test_dw1d_launch_rule(B, L, C, tiles):
    """Kernel 7's tiles a block: 4 at mamba2-2.7b's served and long
    lengths (blocks enough for two an SM), one where the rows are few;
    the grid within CUDA's limits."""
    assert conv_k.dw1d_launch(B, L, C) == tiles
    gx, gy, gz = conv_k.dw1d_grid(B, L, C, tiles)
    assert gx == -(-C // conv_k.DW1D_CHANNELS) and gz == B
    assert 1 <= gy <= 65535 and gy == conv_k.dw1d_runs(L, tiles)


@pytest.mark.parametrize("L,tiles", [(200, 4), (2048, 4), (2048, 2),
                                     (7, 1)])
def test_dw1d_runs_cover_every_tile_once(L, tiles):
    """Block y takes tiles y t .. y t + t - 1: together the blocks take
    every Winograd tile of the rows exactly once, and every block has a
    tile inside the rows."""
    nt = -(-L // 3)
    runs = conv_k.dw1d_grid(1, L, 256, tiles)[1]
    taken = sorted(y * tiles + j for y in range(runs) for j in range(tiles)
                   if y * tiles + j < nt)
    assert taken == list(range(nt))
    assert all(y * tiles < nt for y in range(runs))
    assert runs * tiles * 3 >= L > (runs - 1) * tiles * 3


def test_tiles_1d_match_reference():
    (jx, _, _), (x, _, _) = _dw1d_inputs(3, 10, 4, 4, "float32")
    np.testing.assert_array_equal(wg.tiles_1d(x, 3, 6, 4).numpy(),
                                  np.asarray(j_wg._tiles_1d(jx, 3, 6, 4)))


def test_dw1d_entry_refuses_gradients():
    """Kernel 7's entry now has its backward (ROADMAP item 7d): on CPU
    tensors the gradients autograd takes through it are the plain versions'
    (dx the forward on the reversed cotangent, dw and db the reference's
    reductions), bit for bit, and agree with autograd through the
    pure-torch Winograd route; without grad mode it runs as before."""
    _, (x, w, b) = _dw1d_inputs(0, 12, 4, 4, "float32")
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, 4)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    conv_ops.conv1d_depthwise_causal(*leaves).backward(dy)
    dx = conv_k.conv1d_depthwise_causal_dx_plain(dy, w)
    dw, db = conv_k.conv1d_depthwise_causal_wgrad_plain(x, dy, 4)
    for t, ref in zip(leaves, (dx, dw, db)):
        assert torch.equal(t.grad, ref)
    twin = [t.clone().requires_grad_(True) for t in (x, w, b)]
    conv_ops.conv1d_depthwise_causal(*twin, pallas=False).backward(dy)
    for t, ref in zip(leaves, twin):
        torch.testing.assert_close(t.grad, ref.grad, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        y = conv_ops.conv1d_depthwise_causal(*leaves)
    assert not y.requires_grad


# --- the mixer ----------------------------------------------------------------
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np(tree))


def _mixer(seed=0):
    j_cfg = j_get_config("mamba2-2.7b").reduced()
    cfg = get_config("mamba2-2.7b").reduced()
    j_p = j_nn_ssd.mamba_init(jax.random.PRNGKey(seed), j_cfg)
    # nonzero conv biases, so the bias paths are held too
    rng = np.random.default_rng(seed)
    j_p = dict(j_p)
    for name in ("conv_x", "conv_b", "conv_c"):
        j_p[name] = dict(j_p[name], b=jnp.asarray(rng.standard_normal(
            j_p[name]["b"].shape).astype(np.float32) * 0.1))
    return j_cfg, cfg, j_p, _t(j_p)


def test_conv_decode_step_matches_reference():
    rng = np.random.default_rng(1)
    w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 6), (6,)))
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    xn = rng.standard_normal((2, 1, 6)).astype(np.float32)
    y_ref, s_ref = j_nn_ssd.conv_decode_step(w, b, st, xn)
    y, s = nn_ssd.conv_decode_step(*(torch.from_numpy(a)
                                     for a in (w, b, st, xn)))
    _close(y, y_ref, 1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_ssd_decode_step_matches_reference():
    j_in, t_in = _ssd_inputs(2, 1, 4, 8, 2, 16, "float32")
    st = np.random.default_rng(3).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    y_ref, s_ref = j_nn_ssd.ssd_decode_step(*j_in, jnp.asarray(st))
    y, s = nn_ssd.ssd_decode_step(*t_in, torch.from_numpy(st))
    _close(y, y_ref, 1e-5)
    _close(s, s_ref, 1e-5)


def _mixer_cache(j_cfg, batch):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_nn_ssd.ssm_cache_shape(j_cfg, batch))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches_reference(mode):
    """The reduced mamba2-2.7b mixer (d_inner 128, 16 heads of 8, N 16,
    chunk 16) over 21 tokens (two chunks), caches included; decode is one
    token after that prefill."""
    j_cfg, cfg, j_p, p = _mixer()
    x = np.random.default_rng(4).standard_normal((2, 21, 64)).astype(
        np.float32)
    if mode == "train":
        ref, _ = j_nn_ssd.mamba_apply(j_p, j_cfg, jnp.asarray(x),
                                      mode="train")
        got, cache = nn_ssd.mamba_apply(p, cfg, torch.from_numpy(x),
                                        mode="train")
        assert cache is None
        _close(got, ref, 1e-4)
        return
    ref, j_cache = j_nn_ssd.mamba_apply(j_p, j_cfg, jnp.asarray(x),
                                        mode="prefill",
                                        cache=_mixer_cache(j_cfg, 2))
    cache = {n: torch.zeros(s, dtype=dt)
             for n, (s, dt) in nn_ssd.ssm_cache_shape(cfg, 2).items()}
    got, cache = nn_ssd.mamba_apply(p, cfg, torch.from_numpy(x),
                                    mode="prefill", cache=cache)
    if mode == "decode":
        new = np.random.default_rng(5).standard_normal((2, 1, 64)).astype(
            np.float32)
        ref, j_cache = j_nn_ssd.mamba_apply(j_p, j_cfg, jnp.asarray(new),
                                            mode="decode", cache=j_cache)
        before = cache["state"]
        got, cache = nn_ssd.mamba_apply(p, cfg, torch.from_numpy(new),
                                        mode="decode", cache=cache)
        assert cache["state"] is before                   # in place
    _close(got, ref, 1e-4)
    assert set(cache) == set(j_cache)
    for name, val in cache.items():
        assert val.shape == j_cache[name].shape
        _close(val, j_cache[name], 1e-4)


def test_mamba_init_matches_reference_structure():
    j_cfg, cfg, j_p, _ = _mixer()
    mine = nn_ssd.mamba_init(torch.Generator().manual_seed(0), cfg)
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape)) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape)) for k, v in flat(_np(j_p))[0]]
    for name in ("A_log", "D", "dt_bias"):      # deterministic in both
        _close(mine[name], j_p[name], 1e-6)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
