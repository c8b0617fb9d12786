"""Kernels 2-3 at every F(m,3) and kernel 7 at every tap count, in the
PyTorch port against the JAX package, on the CPU.

The port's CUDA Winograd kernels take every m from 2 to 10 (r = 3, n = m
+ 2 <= 12) and its depthwise kernel every r from 2 to 11 at the
reference's m = {3: 4, 4: 3}.get(r, 2); on a CPU tensor each wrapper runs
its plain version, held here to the reference's Pallas kernels in
interpret mode.  Tolerances: a Winograd conv within max(1e-5, 3 e_ref(m))
of max|y|, e_ref(m) being the reference kernel's own error against its
lax oracle on the same input, measured in the test (the transform's
conditioning grows with m: about 5e-7 at m = 2, 5e-3 at m = 10);
kernel 7 and its gradients within 1e-5 of max|ref| (f32 sums in another
order); the reduced Mamba-2 with ``conv_kernel=3`` within
``tests/test_torch_mamba.py``'s and ``tests/test_torch_train.py``'s
bounds.  Plans compare field by field.  Inputs are made with numpy from a
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
from repro.core import winograd as j_wg  # noqa: E402
from repro.kernels.conv import ops as j_ops  # noqa: E402
from repro.kernels.conv import winograd as j_winograd  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.nn.pooling import LrnParams as JLrn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core import winograd as t_wg  # noqa: E402
from repro_torch.kernels.conv import ops as t_ops  # noqa: E402
from repro_torch.kernels.conv import winograd as t_winograd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import conv as t_conv  # noqa: E402
from repro_torch.nn import module  # noqa: E402
from repro_torch.nn.pooling import LrnParams  # noqa: E402

MS = [2, 3, 6, 8, 10]
TAPS = [2, 3, 5, 8, 11]
# (2,13,13,16) -> 8 channels: unfused (bias + ReLU, groups 2), and conv5's
# epilogue with an LRN in front of its 3/2 pool
CASES = {"unfused": dict(), "lrn_pool": dict(lrn=True, pool=(3, 2))}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 13, 13, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 8)) * 24 ** -0.5).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    return x, w, b


def _kw(case, lib):
    kw = dict(CASES[case], groups=2, relu=True)
    if kw.pop("lrn", False):
        kw["lrn"] = JLrn() if lib == "jax" else LrnParams()
    return kw


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("m", MS)
def test_winograd_plain_matches_jax_kernel_at_every_m(m, case):
    """The port's kernels 2-3 route (the plain version on the CPU) against
    the reference's Pallas kernel in interpret mode at F(m,3)."""
    x, w, b = _inputs()
    jkw = _kw(case, "jax")
    ref = np.asarray(j_winograd.conv2d_winograd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), m=m, interpret=True,
        **jkw))
    oracle = np.asarray(j_ops.conv2d_direct(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pallas=False,
        **jkw))
    scale = np.abs(oracle).max()
    e_ref = np.abs(ref - oracle).max() / scale
    got = t_winograd.conv2d_winograd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), m=m,
        **_kw(case, "torch")).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= max(1e-5, 3 * e_ref) * np.abs(
        ref).max(), (m, e_ref)


@pytest.mark.parametrize("m", list(range(2, 11)))
def test_plan_fields_equal_the_references(m):
    """Every plan field at every m, unfused and pooled (the pooled row
    block aligned to q = m / gcd(ps, m)), armed too, at AlexNet conv3-5's
    and VGG-16's pooled geometries; the port's slab layout is the
    reference's."""
    geos = [((8, 13, 13, 256), (3, 3, 256, 384), dict()),
            ((8, 13, 13, 384), (3, 3, 192, 384), dict(groups=2)),
            ((8, 13, 13, 384), (3, 3, 192, 256), dict(groups=2,
                                                      pool=(3, 2))),
            ((8, 56, 56, 128), (3, 3, 128, 256), dict(pool=(2, 2))),
            ((2, 13, 13, 16), (3, 3, 8, 8), dict(groups=2, lrn="lrn",
                                                 pool=(3, 2), checksum=True))]
    for xs, ws, kw in geos:
        ref = j_winograd.plan(xs, ws, m=m, **kw)
        got = t_winograd.plan(xs, ws, m=m, **kw)
        want = dataclasses.asdict(ref)
        assert dataclasses.asdict(got) == want, (m, xs, kw)
        assert got.weights.tile_shape == ref.weights.tile_shape
        if got.fused and "pool" in kw:
            ps = kw["pool"][1]
            q = m // np.gcd(ps, m)
            assert (got.rows_out % q == 0 and got.row_step * m
                    == ps * got.rows_out)


@pytest.mark.parametrize("m", list(range(2, 11)))
def test_cuda_launch_geometry_at_every_m(m):
    """What the CUDA launcher is handed at F(m,3), AlexNet conv3 at batch
    8: T tiles of the m-grid, n^2 positions in the GEMM's grid and the
    scratches, every tile's origin on the m-grid; the transform matrices
    B^T (n x n) then A^T (m x n)."""
    p = t_winograd.plan((8, 13, 13, 256), (3, 3, 256, 384), m=m)
    n, T = m + 2, 8 * (-(-13 // m)) ** 2
    assert m in t_winograd.CONV_MS and p.n == n
    assert t_winograd.num_tiles(p, 8) == T
    for tile in t_winograd.TILES:
        rows, cols = tile
        assert t_winograd.gemm_grid(p, 8, tile) == (
            -(-T // rows), -(-384 // cols), n * n)
    sh = t_winograd.scratch_shapes(p, 8, None, None)
    assert sh["u"] == (n * n, 1, T, 256) and sh["m"] == (n * n, 1, T, 384)
    for t in range(T):
        b, oy, ox = t_winograd.tile_origin(p, t)
        assert oy % m == 0 and ox % m == 0 and oy < 13 and ox < 13
    mats = t_winograd._mats(p)
    t = t_wg.winograd_transform(m, 3)
    assert mats.shape == (n * n + m * n,)
    assert np.array_equal(mats[:n * n], t.BT.astype(np.float32).ravel())


@pytest.mark.parametrize("m", [2, 6])
def test_autotuner_keys_real_plans_at_m(m):
    """``winograd_m`` keys the tuner's cache: a layer at F(m,3) has its own
    key, every candidate plan (each GEMM tile) is bit-equal to the default
    on the kernels' route, and the winning plan dispatches."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(3))
    spec = t_conv.ConvSpec(kernel=3, groups=2, relu=True, route="pallas",
                           winograd_m=m)
    key = at.plan_key(spec, tuple(x.shape), device="cpu")
    assert key["winograd_m"] == m
    assert at.key_str(key) != at.key_str(at.plan_key(
        dataclasses.replace(spec, winograd_m=4), tuple(x.shape),
        device="cpu"))
    best, rows = at.autotune_layer(spec, x, w, b, iters=1,
                                   check_equal=True)
    assert rows and rows[0]["default"]
    y = t_conv.dispatch_conv(spec, x, w, b, plan=best)
    ref = t_winograd.conv2d_winograd(x, w, b, m=m, groups=2, relu=True)
    assert torch.equal(y, ref)
    packed = t_conv.pack_conv_weights(spec, tuple(x.shape), w)
    assert packed.data.shape[1:3] == (m + 2, m + 2)


# --- kernel 7 at every tap count ---------------------------------------------
def _dw_inputs(r, seed=0, L=23, C=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, C)).astype(np.float32)
    w = (rng.standard_normal((r, C)) * r ** -0.5).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, L, C)).astype(np.float32)
    return x, w, b, dy


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _max_close(got, ref, tol=1e-5):
    assert _rel(got, ref) <= tol


@pytest.mark.parametrize("r", TAPS)
def test_dw1d_and_its_vjp_match_jax_at_every_tap_count(r):
    """Kernel 7's entry (plain on the CPU) and its backward (dx, dw, db)
    against the reference's ``ops.conv1d_depthwise_causal`` (its Pallas
    kernel in interpret mode) and ``jax.vjp``, each within max(1e-5, 3
    e_ref) of max|ref|, e_ref the reference's own error against the
    direct shift-sum oracle's ``jax.vjp`` (F(2,11) is about 1e-5); the
    backward's geometry has r + 1 sums."""
    from repro.kernels.conv.ref import conv1d_depthwise_causal_ref
    x, w, b, dy = _dw_inputs(r)
    m = t_winograd.dw1d_m(r)
    assert m == {3: 4, 4: 3}.get(r, 2) and r in t_winograd.DW1D_TAPS

    def f(x, w, b):
        return j_ops.conv1d_depthwise_causal(x, w, b, pallas=True,
                                             interpret=True)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref, vjp = jax.vjp(f, *args)
    oracle, o_vjp = jax.vjp(conv1d_depthwise_causal_ref, *args)
    refs = (ref, *vjp(jnp.asarray(dy)))
    oracles = (oracle, *o_vjp(jnp.asarray(dy)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = t_ops.conv1d_depthwise_causal(*ts)
    y.backward(torch.from_numpy(dy))
    gots = (y.detach(), *(t.grad for t in ts))
    for name, got, want, orc in zip(("y", "dx", "dw", "db"), gots, refs,
                                    oracles):
        e_ref = _rel(want, orc)
        assert _rel(got.numpy(), want) <= max(1e-5, 3 * e_ref), (name,
                                                                 e_ref)
    assert t_winograd.dw1d_wgrad_scratch_shape(2, 23, 12, r)[1] == r + 1


@pytest.mark.parametrize("r,m", [(2, None), (3, None), (4, None), (5, None),
                                 (4, 2), (3, 2), (5, 3)])
def test_m_keyword_matches_the_references(r, m):
    """``m=None`` takes the reference's rule; an explicit m runs F(m, r):
    the kernel entry against the reference kernel's ``m=`` (interpret
    mode) and the pure-torch twin against the reference's jnp twin."""
    x, w, b, _ = _dw_inputs(r, seed=1, L=17, C=8)
    ref = j_winograd.conv1d_depthwise_causal(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), m=m, interpret=True)
    got = t_winograd.conv1d_depthwise_causal(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), m=m)
    _max_close(got.numpy(), ref)
    j_twin = j_wg.conv1d_depthwise_causal(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), m=m)
    t_twin = t_wg.conv1d_depthwise_causal(torch.from_numpy(x),
                                          torch.from_numpy(w),
                                          torch.from_numpy(b), m=m)
    _max_close(t_twin.numpy(), j_twin)


def test_dw1d_cuda_takes_each_tap_count_at_the_reference_m():
    """The CUDA wrapper's check: every r in 2..11 at the reference's m
    passes, another m or r is refused by name, before any launch; the
    launch geometry's tiles hold m rows."""
    x = torch.zeros((1, 8, 4))
    for r in range(2, 12):
        m = t_winograd.dw1d_m(r)
        t_winograd._check_dw1d_cuda(r, m, x)
        n = m + r - 1               # B^T (n x n), G (n x r), A^T (m x n)
        assert t_winograd._dw1d_mats(m, r).shape == (n * n + n * r + m * n,)
    for r, m in ((4, 2), (12, 2), (1, 2)):
        with pytest.raises(ValueError, match="built for r in 2..11"):
            t_winograd._check_dw1d_cuda(r, m, x)
    assert t_winograd.dw1d_runs(200, 4, m=2) == 25
    assert t_winograd.dw1d_grid(1, 200, 5120, 1, m=4) == (20, 50, 1)


# --- a reduced Mamba-2 at 3 taps ---------------------------------------------
def _mamba3(seed=0):
    j_cfg = j_get_config("mamba2-2.7b").reduced()
    j_cfg = dataclasses.replace(j_cfg, ssm=dataclasses.replace(
        j_cfg.ssm, conv_kernel=3))
    cfg = get_config("mamba2-2.7b").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, conv_kernel=3))
    j_params = j_lm.init(jax.random.PRNGKey(seed), j_cfg)
    params = lm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, j_params), cfg, device="cpu")
    return j_cfg, cfg, j_params, params


def _zeros(j_cfg, batch, max_len):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_lm.cache_shape(j_cfg, batch, max_len))


def test_mamba_at_three_taps_matches_reference():
    """Reduced mamba2-2.7b with ``conv_kernel=3`` (kernel 7 at F(4,3)):
    prefill logits and every cache within 1e-4 (``test_torch_mamba``'s
    bounds), a decode step's logits too."""
    j_cfg, cfg, j_params, params = _mamba3()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21))
    ref, j_caches, _ = j_lm.apply(j_params, j_cfg,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill",
                                  caches=_zeros(j_cfg, 2, 32))
    got, caches, _ = lm.apply(params, cfg, torch.from_numpy(toks),
                              mode="prefill",
                              caches=lm.cache_init(cfg, 2, 32, device="cpu"))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    want = lm.params_from_reference(
        {"stack": jax.tree_util.tree_map(np.asarray, j_caches)}, cfg,
        device="cpu")["stack"]
    for have, ref_layer in zip(caches, want):
        assert have["ssm"]["conv_x"].shape[1] == 2
        for name, t in have["ssm"].items():
            np.testing.assert_allclose(t.numpy(),
                                       ref_layer["ssm"][name].numpy(),
                                       rtol=1e-4, atol=1e-4)
    new = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 1))
    lens = np.array([21, 21], np.int32)
    ref, _, _ = j_lm.apply(j_params, j_cfg, jnp.asarray(new, jnp.int32),
                           mode="decode", length=jnp.asarray(lens),
                           caches=j_caches)
    got, _, _ = lm.apply(params, cfg, torch.from_numpy(new), mode="decode",
                         length=torch.from_numpy(lens), caches=caches)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_mamba_at_three_taps_gradients_match_reference():
    """``loss_fn`` and every gradient of the 3-tap model (kernel 7's
    backward at F(4,3) on the CPU's plain versions) against
    ``jax.value_and_grad``: ``tests/test_torch_train.py``'s bounds."""
    j_cfg, cfg, j_params, params = _mamba3(1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 25)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    (j_loss, _), j_grads = jax.value_and_grad(j_lm.loss_fn, has_aux=True)(
        j_params, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = module.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    ref = module.tree_leaves(lm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, j_grads), cfg, device="cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
