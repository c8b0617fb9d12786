"""The port's hybrid family (reduced jamba-v0.1-52b: attention at index 4
of every 8 layers, the Mamba-2 mixer elsewhere, MoE in every odd layer)
against the JAX package.

The weights are the port's ``lm.init`` carried into the reference's
stacked layout (``lm.to_reference_layout``), the tokens numpy-made from a
seed; everything runs on the CPU (kernels 5, 6 and 7 take their plain
versions there).  Each reference run is made once, in a module-scoped
fixture.  Tolerances: logits within 1e-5 * max|logit| in f32, caches
within 1e-5 of each buffer's largest value, the router loss and
``loss_fn`` 1e-5 relative, every gradient leaf within 1e-5 of the largest
gradient, the Engine's greedy tokens exactly (prompts of 3 tokens or
more: below that the reference keeps a short conv cache, ROADMAP Queue
3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import lm, model_for
from repro_torch.nn import blocks
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.serving import Engine, Request, ServeConfig

ARCH = "jamba-v0.1-52b"
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jax(params, cfg):
    """The port's params in the reference's stacked layout, as jnp."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().numpy()),
        lm.to_reference_layout(params, cfg, device="cpu"))


def caches_from_reference(j_caches, cfg):
    return lm.params_from_reference({"stack": _np(j_caches)}, cfg,
                                    device="cpu")["stack"]


def close_logits(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def close_caches(got, j_caches, cfg):
    """Every layer's cache buffers, by mixer kind and name."""
    want = caches_from_reference(j_caches, cfg)
    kinds = [mixer for mixer, _ in blocks.stack_kinds(cfg)]
    assert [set(c) for c in got] == [{k} for k in kinds]
    for have, ref_layer in zip(got, want):
        assert set(have) == set(ref_layer)
        for kind, bufs in have.items():
            assert set(bufs) == set(ref_layer[kind])
            for name, t in bufs.items():
                r = ref_layer[kind][name].numpy()
                np.testing.assert_allclose(
                    t.numpy(), r, rtol=TOL,
                    atol=TOL * max(float(np.abs(r).max()), 1.0))


@pytest.fixture(scope="module")
def model():
    j_cfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = lm.init(0, cfg, device="cpu")
    return j_cfg, cfg, to_jax(params, cfg), params


def _zeros(j_cfg, batch, max_len):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_lm.cache_shape(j_cfg, batch, max_len))


@pytest.fixture(scope="module")
def ref(model):
    """The reference's logits (and router loss) in train mode, and its
    logits and caches after a 21-token prefill (two 16-token chunks) and
    one decode step."""
    j_cfg, cfg, j_params, _ = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    lens = np.array([21, 21], np.int32)
    out = {"toks": toks, "new": new, "lens": lens}
    out["train"], _, out["aux"] = j_lm.apply(
        j_params, j_cfg, jnp.asarray(toks, jnp.int32), collect_aux=True)
    out["prefill"], out["prefill_caches"], _ = j_lm.apply(
        j_params, j_cfg, jnp.asarray(toks, jnp.int32), mode="prefill",
        caches=_zeros(j_cfg, 2, 32))
    out["decode"], out["decode_caches"], _ = j_lm.apply(
        j_params, j_cfg, jnp.asarray(new, jnp.int32), mode="decode",
        length=jnp.asarray(lens), caches=out["prefill_caches"])
    return out


# --- config and dispatch ----------------------------------------------------
def test_config_matches_reference():
    for full in (True, False):
        j_cfg, cfg = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j_cfg, cfg = j_cfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
        assert cfg.pattern_period() == j_cfg.pattern_period() == 8
        assert (cfg.d_inner, cfg.ssm_heads) == (j_cfg.d_inner,
                                                j_cfg.ssm_heads)
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [j_cfg.layer_kind(i) for i in range(j_cfg.num_layers)]
    full = get_config(ARCH)
    kinds = blocks.stack_kinds(full)
    assert [i for i, (m, _) in enumerate(kinds) if m == "attn"] == \
        [4, 12, 20, 28]
    assert [i for i, (_, f) in enumerate(kinds) if f == "moe"] == \
        list(range(1, 32, 2))
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.d_head, full.d_inner, full.ssm_heads,
            full.ssm.d_state, full.ssm.head_dim, full.ssm.chunk,
            full.moe.num_experts, full.moe.top_k, full.moe.d_ff) == \
        (32, 4096, 32, 8, 128, 8192, 128, 16, 64, 256, 16, 2, 14_336)
    assert ARCH in LM_ARCHS
    assert model_for(full) is lm and model_for(full.reduced()) is lm


def test_init_and_caches_match_reference_structure(model):
    """The port's params in the reference's layout have the reference
    init's leaf paths, shapes and dtypes; each layer's cache is its
    mixer's (attention K and V on layers 4 and 12, conv windows and
    state elsewhere), of the reference's shapes."""
    j_cfg, cfg, j_params, _ = model
    flat = jax.tree_util.tree_flatten_with_path
    want = jax.eval_shape(lambda k: j_lm.init(k, j_cfg),
                          jax.random.PRNGKey(0))
    assert [(k, v.shape, v.dtype) for k, v in flat(j_params)[0]] == \
        [(k, v.shape, v.dtype) for k, v in flat(want)[0]]
    caches = lm.cache_init(cfg, 3, 32, device="cpu")
    assert [i for i, c in enumerate(caches) if "attn" in c] == [4, 12]
    ref_caches = caches_from_reference(_zeros(j_cfg, 3, 32), cfg)
    assert [{k: {n: (tuple(t.shape), t.dtype) for n, t in b.items()}
             for k, b in c.items()} for c in caches] == \
        [{k: {n: (tuple(t.shape), t.dtype) for n, t in b.items()}
          for k, b in c.items()} for c in ref_caches]


# --- the model --------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_matches_reference(model, ref, mode):
    """Logits in all three modes, the router loss, and every layer's
    caches after prefill and decode; on the CPU no kernel launches."""
    j_cfg, cfg, _, params = model
    for ops in (ssd_ops, conv_ops, dec_ops):
        ops.reset_launch_counts()
    toks = torch.from_numpy(ref["toks"])
    if mode == "train":
        got, caches, aux = lm.apply(params, cfg, toks, collect_aux=True)
        np.testing.assert_allclose(float(aux), float(ref["aux"]), rtol=TOL)
    else:
        caches = lm.cache_init(cfg, 2, 32, device="cpu")
        got, caches, _ = lm.apply(params, cfg, toks, mode="prefill",
                                  caches=caches)
        if mode == "decode":
            caches = caches_from_reference(ref["prefill_caches"], cfg)
            got, caches, _ = lm.apply(
                params, cfg, torch.from_numpy(ref["new"]), mode="decode",
                length=torch.from_numpy(ref["lens"]), caches=caches)
    assert got.dtype == torch.float32 and tuple(got.shape) == \
        ref[mode].shape
    close_logits(got, ref[mode])
    if mode != "train":
        close_caches(caches, ref[f"{mode}_caches"], cfg)
    assert ssd_ops.launch_counts() == {"ssd": 0}
    assert dec_ops.launch_counts()["decode_attn"] == 0
    assert not any(conv_ops.launch_counts().values())


def test_loss_fn_and_gradients_match_reference(model):
    """``loss_fn`` with the router loss, its metrics, and every gradient
    leaf (targets partly masked)."""
    j_cfg, cfg, j_params, params = model
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, cfg.vocab_size, (2, 20))
    targets = rng.integers(0, cfg.vocab_size, (2, 20))
    targets[0, :5] = -1
    j_batch = {"inputs": jnp.asarray(inputs, jnp.int32),
               "targets": jnp.asarray(targets, jnp.int32)}
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm.loss_fn(p, j_cfg, b), has_aux=True))(j_params,
                                                               j_batch)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(p)
    total, metrics = lm.loss_fn(p, cfg, {"inputs": torch.from_numpy(inputs),
                                         "targets": torch.from_numpy(
                                             targets)})
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(j_total),
                               rtol=TOL)
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=TOL, atol=TOL)
    assert float(metrics["aux_loss"]) > 0
    assert int(metrics["tokens"]) == int(j_metrics["tokens"]) == 35
    want = tree_leaves(lm.params_from_reference(_np(j_grads), cfg,
                                                device="cpu"))
    gmax = max(float(w.abs().max()) for w in want)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * gmax)


# --- the Engine -------------------------------------------------------------
def test_engine_tokens_match_jax_engine(model):
    """Prompts of 3 or more tokens (one over a 16-token chunk), more
    requests than slots: exact-length prefills, slot reuse, the batched
    decode of attention caches and SSM states in one tree."""
    j_cfg, cfg, j_params, params = model
    prompts = [list(range(1, n + 1)) for n in (5, 3, 19)]
    skw = dict(max_batch=2, max_len=48)
    out = []
    for e, req in ((JEngine(j_cfg, JServeConfig(**skw), params=j_params),
                    JRequest),
                   (Engine(cfg, ServeConfig(**skw), params=params,
                           device="cpu"), Request)):
        reqs = [req(prompt=p, max_new=4) for p in prompts]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done and len(r.generated) == 4 for r in reqs)
        out.append(([r.generated for r in reqs], e.decode_steps,
                     e.tokens_generated))
    assert out[0] == out[1]


def test_engine_prefills_at_exact_length(model):
    _, cfg, _, params = model
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=64,
                                  prefill_bucket=16), params=params,
                 device="cpu")
    assert [eng._pad_len(n) for n in (1, 5, 17)] == [1, 5, 17]


def test_engine_insert_covers_both_cache_kinds(model):
    """After admission the slot holds the one-row prefill's attention K
    and V and its conv windows and states; the other slot keeps its
    zeros."""
    _, cfg, _, params = model
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=32), params=params,
                 device="cpu")
    prompt = [7, 3, 9, 4, 2]
    eng.submit(Request(prompt=prompt, max_new=3))
    eng._admit()
    one = lm.cache_init(cfg, 1, 32, device="cpu")
    lm.apply(params, cfg, torch.tensor([prompt]), mode="prefill",
             caches=one)
    kinds = set()
    for full, row in zip(eng.cache, one):
        for kind, bufs in full.items():
            kinds.add(kind)
            for name, buf in bufs.items():
                assert torch.equal(buf[0], row[kind][name][0])
                assert row[kind][name][0].any()
                assert not buf[1].any()
    assert kinds == {"attn", "ssm"}


def test_serve_cli_hybrid_on_the_cpu(capsys):
    for ops in (ssd_ops, conv_ops, dec_ops):
        ops.reset_launch_counts()
    serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "3",
                "--max-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    assert ssd_ops.launch_counts() == {"ssd": 0}
    assert dec_ops.launch_counts()["decode_attn"] == 0
