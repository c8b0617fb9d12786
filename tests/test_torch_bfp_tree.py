"""BFP-compressed linears (``quantize_linear_tree``, ``dequantize_linear``,
``weight_of`` and ``linear`` on a ``w_q`` leaf; paper §3.6, the
reference's ``bfp8`` serving weights) against the JAX package.

The reference's scales go through ``jnp.exp2``, inexact on XLA's CPU
beyond +-12 (ROADMAP Queue 3); the tests patch it exact for their whole
module, as ``tests/test_torch_bfp.py::exact_jax_exp2`` does per test.
Under it the mantissas and exponents are bit-equal, leaf for leaf, and
so is every dequantized weight.  Models: the port's ``lm.init`` carried
into the reference's layout; logits with quantized linears within 1e-5
* max|logit| in f32 and the Engine's greedy tokens exactly (prompts of 3
tokens or more, as in ``tests/test_torch_hybrid.py``).  At reduced width
``min_size`` 256 makes every linear quantize.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.core import bfp as j_bfp
from repro.models import lm as j_lm
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.core import bfp
from repro_torch.models import lm
from repro_torch.nn import layers
from repro_torch.nn.module import tree_leaves
from repro_torch.serving import Engine, Request, ServeConfig

ARCHS = ["jamba-v0.1-52b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
SMALL = 256         # min_size under which every reduced linear quantizes
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _exact_exp2():
    """The reference's ``jnp.exp2`` exact for the integer arguments its BFP
    code gives it (``jnp.ldexp``), the jit caches cleared around the
    module."""
    def exp2(v):
        v = jnp.asarray(v)
        return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                         jnp.round(v).astype(jnp.int32))
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", exp2)
        yield
    jax.clear_caches()


def to_jax(tree, cfg):
    """A port params tree in the reference's stacked layout, as jnp."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().float().numpy()),
        lm.to_reference_layout(tree, cfg, device="cpu"))


def _paths(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def models():
    """Each reduced arch: (reference config, config, the port's init)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        out[arch] = (j_get_config(arch).reduced(), cfg,
                     lm.init(1, cfg, device="cpu"))
    return out


def _same_tree(got, want):
    """Two trees in the reference's layout with the same leaf paths, the
    int8 leaves equal bit for bit, the others equal in value."""
    got, want = _paths(got), _paths(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.shape == w.shape, k
        if w.dtype == np.int8:
            assert g.dtype == np.int8 and np.array_equal(g, w), k
        else:
            np.testing.assert_array_equal(g.astype(np.float32),
                                          w.astype(np.float32), err_msg=k)


def _port_in_reference_layout(qtree, cfg):
    """The port's quantized tree stacked as the reference stacks it, int8
    leaves kept as numpy int8."""
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if t.dtype == torch.int8
        else t.detach().float().numpy(),
        lm.to_reference_layout(qtree, cfg, device="cpu"))


# --- the tree ----------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("min_size", [SMALL, 1 << 12, 1 << 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_linear_tree_matches_reference(models, arch, min_size,
                                                param_dtype):
    """The same leaves quantize (judged on the reference's stacked leaves:
    granite's routers, deepseek's dense prefix layer), to the same
    mantissas and exponents; every other leaf is the port's own tensor.
    bf16 parameters are the reference's ``bfp8`` serving dtype."""
    _, cfg, params = models[arch]
    dt = getattr(torch, param_dtype)
    params = jax.tree_util.tree_map(lambda t: t.to(dt), params)
    j_params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if param_dtype == "bfloat16"
        else a, to_jax(params, cfg))
    want = j_bfp.quantize_linear_tree(j_params, min_size=min_size)
    got = lm.quantize_linear_tree(params, cfg, min_size=min_size)
    _same_tree(_port_in_reference_layout(got, cfg), want)
    n_q = sum(k.endswith("_q']") for k in _paths(want))
    if min_size == SMALL:
        # every linear whose K axis holds whole blocks (attention, MLP, SSM
        # projections, routers, experts, the untied head); not the conv
        # windows (4, ch) nor deepseek's (32, ..) MLA up-projections
        left = [v.shape for k, v in _paths(want).items()
                if k.endswith(("['w']", "['w1']", "['w2']", "['w3']"))]
        assert all(shape[-2] % 64 for shape in left)
    assert n_q > 0 or min_size == 1 << 16
    kept = {id(t) for t in tree_leaves(params)}
    for t in tree_leaves(got):
        if t.dtype != torch.int8:
            assert id(t) in kept


def test_quantize_linear_tree_rule_on_odd_leaves():
    """The ``quantizable`` rule against the reference's on one tree: 1-D,
    5-D and integer leaves, a K axis off the block, ``min_size`` at and
    below the leaf, keys outside ``QKEYS``, leaves in lists."""
    rng = np.random.default_rng(0)

    def arr(*shape, dtype=np.float32):
        return (rng.standard_normal(shape) * 0.3).astype(dtype)
    tree = {"a": {"w": arr(128, 32)},                # 4096: at min_size
            "b": {"w": arr(64, 63)},                 # 4032: below
            "c": {"w": arr(96, 64)},                 # K off the block
            "d": {"w1": arr(2, 64, 40), "w2": arr(2, 2, 64, 40),
                  "w3": arr(1, 2, 2, 64, 40)},       # 3-D, 4-D, 5-D
            "e": {"w": arr(8192)},                   # 1-D
            "f": {"w": np.arange(64 * 64, dtype=np.int32).reshape(64, 64)},
            "g": {"v": arr(64, 128)},                # not a QKEY
            "h": [{"w": arr(64, 64)}, {"w": arr(64, 16)}]}
    want = j_bfp.quantize_linear_tree(
        jax.tree_util.tree_map(jnp.asarray, tree), min_size=4096)
    got = bfp.quantize_linear_tree(
        jax.tree_util.tree_map(torch.from_numpy, tree), min_size=4096)
    _same_tree(jax.tree_util.tree_map(lambda t: t.numpy(), got), want)
    assert set(got["a"]) == {"w_q", "w_e"} and set(got["b"]) == {"w"}
    assert set(got["d"]) == {"w1_q", "w1_e", "w2_q", "w2_e", "w3"}
    assert set(got["h"][0]) == {"w_q", "w_e"} and set(got["h"][1]) == {"w"}
    # a layer of a stack of 2 is judged as the stacked leaf: 2 * 4032
    # elements pass min_size 4096, and a (64,) leaf stacks to 2-D
    assert bfp.quantizable(torch.zeros(64, 63), min_size=4096, stack=2)
    assert not bfp.quantizable(torch.zeros(64, 63), min_size=4096)
    assert not bfp.quantizable(torch.zeros(2, 2, 64, 40), min_size=1,
                               stack=2)
    assert bfp.quantizable(torch.zeros(64), min_size=1, stack=64)


@pytest.mark.parametrize("shape,scale", [((128, 40), 1.0),
                                         ((3, 64, 40), 3e-4),
                                         ((2, 3, 192, 8), 2e5)])
def test_dequantize_linear_and_weight_of_match_reference(shape, scale):
    """``dequantize_linear`` bit-equal to the reference's (magnitudes
    beyond exp2's +-12 too, under the exact patch); ``weight_of`` casts
    the dequantized weight, or the raw one, to the asked dtype."""
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[..., :64, 0] = 0.0                       # a block of zeros
    j_p = j_bfp.quantize_linear_tree({"w": jnp.asarray(w)}, min_size=1)
    p = bfp.quantize_linear_tree({"w": torch.from_numpy(w)}, min_size=1)
    assert np.array_equal(p["w_q"].numpy(), np.asarray(j_p["w_q"]))
    assert np.array_equal(p["w_e"].numpy(), np.asarray(j_p["w_e"]))
    got = bfp.dequantize_linear(p)
    want = np.asarray(j_bfp.dequantize_linear(j_p))
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert np.array_equal(got.numpy(), want)
    bound = np.asarray(j_bfp.error_bound(j_p["w_e"]))
    assert np.all(np.abs(got.numpy() - w) <= np.expand_dims(
        bound, -2).repeat(64, -2).reshape(w.shape))
    half = bfp.weight_of(p, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(
        half, got.to(torch.bfloat16))
    raw = {"w": torch.from_numpy(w)}
    assert bfp.weight_of(raw) is raw["w"]


def test_linear_dequantizes_then_casts():
    """``linear`` on a quantized weight: the dequantized f32 weight cast
    to the activation dtype (or ``dtype``), bias kept, as the
    reference's ``linear``."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((128, 24)).astype(np.float32) * 0.1
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    j_p = j_bfp.quantize_linear_tree({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, min_size=1)
    p = bfp.quantize_linear_tree({"w": torch.from_numpy(w),
                                  "b": torch.from_numpy(b)}, min_size=1)
    assert set(p) == {"w_q", "w_e", "b"}
    from repro.nn import layers as j_layers
    for dt, jdt in ((None, None), (torch.float32, jnp.float32)):
        got = layers.linear(p, torch.from_numpy(x), dtype=dt)
        want = np.asarray(j_layers.linear(j_p, jnp.asarray(x), dtype=jdt))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    wd = bfp.dequantize_linear(p)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.linear(p, xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, xb @ wd.to(torch.bfloat16)
                       + p["b"].to(torch.bfloat16))


# --- models with quantized linears -------------------------------------------
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_quantized_logits_match_reference(models, arch):
    """Reduced jamba and granite with every linear quantized: prefill
    logits (kernels' plain versions on the CPU) and one decode step
    against the reference's on its quantized tree, and different from
    the unquantized model's."""
    j_cfg, cfg, params = models[arch]
    q = lm.quantize_linear_tree(params, cfg, min_size=SMALL)
    j_q = j_bfp.quantize_linear_tree(to_jax(params, cfg), min_size=SMALL)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 20))
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   j_lm.cache_shape(j_cfg, 2, 32))
    j_pre, j_caches, _ = j_lm.apply(j_q, j_cfg, jnp.asarray(toks, jnp.int32),
                                    mode="prefill", caches=zeros)
    j_dec, _, _ = j_lm.apply(j_q, j_cfg, jnp.asarray(new, jnp.int32),
                             mode="decode", length=jnp.asarray([20, 20]),
                             caches=j_caches)
    caches = lm.cache_init(cfg, 2, 32, device="cpu")
    pre, caches, _ = lm.apply(q, cfg, torch.from_numpy(toks),
                              mode="prefill", caches=caches)
    dec, _, _ = lm.apply(q, cfg, torch.from_numpy(new), mode="decode",
                         length=torch.tensor([20, 20]), caches=caches)
    for got, want in ((pre, j_pre), (dec, j_dec)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())
    plain, _, _ = lm.apply(params, cfg, torch.from_numpy(toks))
    assert float((plain - pre).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_quantized_engine_tokens_match_jax_engine(models, arch):
    """The Engine serving a quantized tree gives the reference Engine's
    greedy tokens on its quantized tree."""
    j_cfg, cfg, params = models[arch]
    q = lm.quantize_linear_tree(params, cfg, min_size=SMALL)
    j_q = j_bfp.quantize_linear_tree(to_jax(params, cfg), min_size=SMALL)
    prompts = [list(range(2, n + 2)) for n in (6, 3, 6)]
    skw = dict(max_batch=2, max_len=48, prefill_bucket=8)
    out = []
    for e, req in ((JEngine(j_cfg, JServeConfig(**skw), params=j_q),
                    JRequest),
                   (Engine(cfg, ServeConfig(**skw), params=q, device="cpu"),
                    Request)):
        reqs = [req(prompt=p, max_new=4) for p in prompts]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done and len(r.generated) == 4 for r in reqs)
        out.append(([r.generated for r in reqs], e.decode_steps))
    assert out[0] == out[1]
