"""The port's dense and mixture-of-experts LM stacks and the token Engine
against the JAX package.

Same numpy-made inputs on both sides, weights carried over from the
reference with ``lm.params_from_reference``, all on the CPU (kernel 5 and
kernel 4 take their plain versions there).  Tolerances: the elementwise
layers 1e-6; ``lm.apply`` logits 1e-4 * max|logit| in f32 (summation
orders differ); the MoE router loss and ``loss_fn`` 1e-5 relative; the
Engine's greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)
from test_torch_bfp import exact_jax_exp2  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro.nn import attention as j_attn
from repro.nn import flash as j_flash
from repro.nn import layers as j_layers
from repro.nn import mlp as j_mlp
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.bfp_matmul import ops as bfp_ops
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.launch import serve
from repro_torch.models import lm, model_for
from repro_torch.nn import attention, blocks, flash, layers, mlp, module
from repro_torch.serving import Engine, Request, ServeConfig

ARCHS = ["smollm-360m", "llama3.2-3b", "starcoder2-15b", "phi4-mini-3.8b"]
# GQA + MoE on every layer; MLA + MoE after one dense layer
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(arch, seed=0, **change):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(), **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    j_params = j_lm.init(jax.random.PRNGKey(seed), j_cfg)
    params = lm.params_from_reference(_np(j_params), cfg, device="cpu")
    return j_cfg, cfg, j_params, params


def _caches_from_reference(j_caches, cfg):
    """The reference's scan-stacked caches as the port's per-layer list:
    they unstack as the parameters' ``stack`` does."""
    return lm.params_from_reference({"stack": _np(j_caches)}, cfg,
                                    device="cpu")["stack"]


def _close_logits(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * scale)


# --- configs and dispatch ----------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_configs_match_reference(arch):
    for full in (True, False):
        j_cfg, cfg = j_get_config(arch), get_config(arch)
        if not full:
            j_cfg, cfg = j_cfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
        assert cfg.d_head == j_cfg.d_head
        assert cfg.pattern_period() == j_cfg.pattern_period()
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [j_cfg.layer_kind(i) for i in range(j_cfg.num_layers)]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_unported_archs_raise_with_their_roadmap_item(arch):
    """The last config the port refused (item 7c) is ported: it is the
    reference's and the LM serves it."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert model_for(cfg) is lm


def test_pattern_periodicity_on_the_ports_configs():
    """The reference's ``test_pattern_periodicity`` facts: deepseek's first
    layer is dense and the rest MoE; granite is MoE on every layer; the
    stack runs them in that order."""
    d = get_config("deepseek-v2-lite-16b")
    assert d.layer_kind(0) == ("attn", "mlp")
    assert d.layer_kind(1) == ("attn", "moe")
    assert d.layer_kind(26) == ("attn", "moe")
    assert blocks.stack_kinds(d) == [("attn", "mlp")] + [("attn", "moe")] * 26
    g = get_config("granite-moe-1b-a400m")
    assert blocks.stack_kinds(g) == [("attn", "moe")] * 24
    assert blocks.stack_kinds(d.reduced()) == [("attn", "mlp")] + \
        [("attn", "moe")] * 2
    assert model_for(d) is lm and model_for(g) is lm


@pytest.mark.parametrize("family", ["hybrid"])
def test_unported_families_raise_with_their_roadmap_item(family):
    """The last family the port refused (item 7c) goes to the LM; a name
    no package knows is refused."""
    cfg = dataclasses.replace(get_config("smollm-360m"), family=family)
    assert model_for(cfg) is lm
    with pytest.raises(ValueError, match="unknown model family"):
        model_for(dataclasses.replace(cfg, family="graph"))


def test_default_device_is_the_card():
    """Without a card the entry points raise unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, ServeConfig())


# --- layers ------------------------------------------------------------------
def _layer_cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    t = torch.from_numpy
    return {
        "rmsnorm": (lambda: j_layers.rmsnorm({"scale": scale}, x2),
                    lambda: layers.rmsnorm({"scale": t(scale)}, t(x2))),
        "layernorm": (
            lambda: j_layers.layernorm({"scale": scale, "bias": bias}, x2),
            lambda: layers.layernorm({"scale": t(scale), "bias": t(bias)},
                                     t(x2))),
        "rope_heads": (lambda: j_layers.rope(x, pos, 500_000.0),
                       lambda: layers.rope(t(x), t(pos), 500_000.0)),
        "rope_no_heads": (lambda: j_layers.rope(x2[..., :16], pos[:1]),
                          lambda: layers.rope(t(x2[..., :16]), t(pos[:1]))),
    }


LAYER_CASES = ["rmsnorm", "layernorm", "rope_heads", "rope_no_heads"]


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layers_match_reference(name):
    ref, got = _layer_cases()[name]
    np.testing.assert_allclose(got().numpy(), np.asarray(ref()), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "starcoder2-15b"])
def test_mlp_matches_reference(arch):
    """SwiGLU (smollm-360m) and the tanh-approximate GELU with biases
    (starcoder2-15b; jax.nn.gelu's default)."""
    j_cfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    p = _np(j_mlp.mlp_init(jax.random.PRNGKey(1), j_cfg))
    if "b" in p["w1"]:
        rng = np.random.default_rng(2)
        for k in ("w1", "w2"):
            p[k]["b"] = rng.standard_normal(p[k]["b"].shape).astype(
                np.float32)
    x = np.random.default_rng(3).standard_normal((2, 4, 64)).astype(
        np.float32) * 2
    got = mlp.mlp_apply(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p),
        cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_mlp.mlp_apply(p, j_cfg, x)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 8e-3)])
def test_flash_attention_matches_reference(dtype, tol):
    """1,100 positions: two q tiles and two k tiles of the reference's 512 x
    1024 tiling, causal, G = 3.  In bf16 the per-tile probability rounding
    is the reference's; the outputs agree within two bf16 steps."""
    rng = np.random.default_rng(6)
    jdt = getattr(jnp, dtype)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
            for shape in ((1, 1100, 6, 8), (1, 1100, 2, 8), (1, 1100, 2, 8))]
    ref = j_flash.flash_attention(*(jnp.asarray(a) for a in arrs),
                                  causal=True)
    got = flash.flash_attention(
        *(torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs), causal=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("length", [0, 5, 9, 12, [0, 3, 11], [12, 2, 10]])
def test_cache_write_clamps_like_dynamic_update_slice(length):
    """Offsets past max_len - S clamp to it, as in the reference."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((3, 12, 2, 4)).astype(np.float32)
    val = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    ref = j_attn.cache_write(jnp.asarray(buf), jnp.asarray(val),
                             jnp.asarray(length, jnp.int32))
    out = torch.from_numpy(buf.copy())
    got = attention.cache_write(out, torch.from_numpy(val),
                                torch.tensor(length))
    assert got is out                                  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- the model ---------------------------------------------------------------
def _apply_both(arch, mode):
    j_cfg, cfg, j_params, params = _reference(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    if mode == "train":
        ref, _, _ = j_lm.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32))
        got, _, _ = lm.apply(params, cfg, torch.from_numpy(toks))
        return got, ref, None, None
    L = 24
    j_caches = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), j_lm.cache_shape(j_cfg, 2, L))
    ref, j_caches, _ = j_lm.apply(j_params, j_cfg,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill", caches=j_caches)
    if mode == "prefill":
        got, caches, _ = lm.apply(params, cfg, torch.from_numpy(toks),
                                  mode="prefill",
                                  caches=lm.cache_init(cfg, 2, L,
                                                       device="cpu"))
        return got, ref, caches, j_caches
    # decode one token per slot at ragged offsets from the reference's cache
    lens = np.array([11, 6], np.int32)
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    caches = _caches_from_reference(j_caches, cfg)
    ref, j_caches, _ = j_lm.apply(j_params, j_cfg,
                                  jnp.asarray(new, jnp.int32), mode="decode",
                                  length=jnp.asarray(lens), caches=j_caches)
    got, caches, _ = lm.apply(params, cfg, torch.from_numpy(new),
                              mode="decode", length=torch.from_numpy(lens),
                              caches=caches)
    return got, ref, caches, j_caches


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_apply_matches_reference(arch, mode):
    """Logits in all three modes, and the caches that prefill and decode
    leave, by their own names (GQA's k and v, MLA's ckv and kpe), on
    reduced smollm-360m, llama3.2-3b, starcoder2-15b (untied, LayerNorm,
    GELU, biases), phi4-mini-3.8b, granite-moe-1b-a400m and
    deepseek-v2-lite-16b (a dense prefix layer, MLA)."""
    got, ref, caches, j_caches = _apply_both(arch, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close_logits(got, ref)
    if caches is not None:
        want = _caches_from_reference(j_caches, get_config(arch).reduced())
        names = {"ckv", "kpe"} if arch.startswith("deepseek") else {"k", "v"}
        assert len(caches) == len(want)
        for have, ref_layer in zip(caches, want):
            assert set(have["attn"]) == set(ref_layer["attn"]) == names
            for name in names:
                np.testing.assert_allclose(have["attn"][name].numpy(),
                                           ref_layer["attn"][name].numpy(),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_aux_and_loss_match_reference(arch):
    """``collect_aux``: the MoE layers' router loss summed over the stack,
    and ``loss_fn``'s total and metrics, against the reference's."""
    j_cfg, cfg, j_params, params = _reference(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 20))
    tgt = rng.integers(-1, cfg.vocab_size, (2, 20))
    _, _, j_aux = j_lm.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32),
                             collect_aux=True)
    _, _, aux = lm.apply(params, cfg, torch.from_numpy(toks),
                         collect_aux=True)
    assert float(j_aux) > 0
    assert float(aux) == pytest.approx(float(j_aux), rel=1e-5)
    assert float(lm.apply(params, cfg, torch.from_numpy(toks))[2]) == 0.0
    j_total, j_m = j_lm.loss_fn(
        j_params, j_cfg, {"inputs": jnp.asarray(toks, jnp.int32),
                          "targets": jnp.asarray(tgt, jnp.int32)})
    total, m = lm.loss_fn(params, cfg, {"inputs": torch.from_numpy(toks),
                                        "targets": torch.from_numpy(tgt)})
    assert float(total) == pytest.approx(float(j_total), rel=1e-5)
    for k in ("loss", "aux_loss", "accuracy"):
        assert float(m[k]) == pytest.approx(float(j_m[k]), rel=1e-5)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "deepseek-v2-lite-16b"])
def test_init_matches_reference_structure(arch):
    """The port's init draws the reference's tree, shapes and dtypes, with
    the stack as one dict per layer (deepseek: a dense layer, then MLA +
    MoE layers)."""
    cfg = get_config(arch).reduced()
    _, _, _, carried = _reference(arch)
    mine = lm.init(0, cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(carried)[0]]
    assert len(mine["stack"]) == cfg.num_layers


def test_reference_layout_with_a_prefix_round_trips():
    """Reduced deepseek: ``to_reference_layout`` puts layer 0 in "prefix"
    and stacks the MoE layers in "scan", leaf for leaf the reference's tree
    (names, shapes, dtypes, values); ``from_reference_layout`` undoes it."""
    _, cfg, j_params, params = _reference("deepseek-v2-lite-16b")
    ref = lm.to_reference_layout(params, cfg)
    assert len(ref["stack"]["prefix"]) == 1
    flat_j = jax.tree_util.tree_flatten_with_path(j_params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [jax.tree_util.keystr(p) for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = lm.from_reference_layout(ref, cfg)
    assert len(back["stack"]) == cfg.num_layers
    for a, b in zip(module.tree_leaves(back), module.tree_leaves(params)):
        assert torch.equal(a, b)


# --- the Engine --------------------------------------------------------------
# (arch, seed, ServeConfig kwargs, prompts, max_new): the reference's
# test_engine_matches_greedy_reference and
# test_continuous_batching_mixed_lengths
ENGINE_CASES = {
    "greedy_llama": ("llama3.2-3b", 0,
                     dict(max_batch=2, max_len=64, prefill_bucket=8),
                     [[3, 1, 4, 1, 5, 9, 2, 6]], 5),
    "mixed_lengths_smollm": ("smollm-360m", 1,
                             dict(max_batch=3, max_len=96,
                                  prefill_bucket=16),
                             [list(range(1, n + 1))
                              for n in (5, 12, 3, 20, 7, 9)], 4),
    # prompts of 17 and 20 pad to 24: the MoE's second group of 16 then
    # holds 8 zero rows, routed like tokens
    "moe_granite": ("granite-moe-1b-a400m", 2,
                    dict(max_batch=2, max_len=64, prefill_bucket=8),
                    [[(7 * i + 3) % 503 + 1 for i in range(n)]
                     for n in (5, 17, 20, 9)], 5),
    "moe_mla_deepseek": ("deepseek-v2-lite-16b", 3,
                         dict(max_batch=2, max_len=64, prefill_bucket=8),
                         [[(11 * i + 5) % 503 + 1 for i in range(n)]
                          for n in (5, 17, 20, 9)], 5),
}


def _serve_both(arch, seed, skw, prompts, max_new, **change):
    j_cfg, cfg, _, _ = _reference(arch, **change)
    j_eng = JEngine(j_cfg, JServeConfig(**skw), seed=seed)
    eng = Engine(cfg, ServeConfig(**skw), device="cpu",
                 params=lm.params_from_reference(_np(j_eng.params), cfg,
                                                 device="cpu"))
    out = []
    for e, req in ((j_eng, JRequest), (eng, Request)):
        reqs = [req(prompt=p, max_new=max_new) for p in prompts]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done and len(r.generated) == max_new for r in reqs)
        out.append([r.generated for r in reqs])
    return j_eng, eng, out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_match_jax_engine(case):
    j_eng, eng, (ref, got) = _serve_both(*ENGINE_CASES[case])
    assert got == ref
    assert eng.tokens_generated == j_eng.tokens_generated
    assert eng.decode_steps == j_eng.decode_steps
    assert eng.decode_tokens_per_s > 0


def test_engine_shares_scheduler_core():
    """The reference's test_engine_shares_scheduler_core on the port."""
    cfg = get_config("smollm-360m").reduced()
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=64, prefill_bucket=8),
                 seed=4, device="cpu")
    reqs = [Request(prompt=[1, 2, 3, 4], max_new=3) for _ in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.sched.submitted == eng.sched.completed == 3
    assert eng.sched.idle and eng.sched.occupancy == 0
    assert len(eng.latency) == 3
    lat = eng.latency.percentiles_ms()
    assert 0 < lat["p50"] <= lat["p99"]
    assert all(r.t_done >= r.t_submit > 0 for r in reqs)
    assert eng.active.tolist() == [False, False]
    assert list(eng.queue) == [] and eng.slot_req == [None, None]


def test_engine_lengths_advance_only_on_active_slots():
    cfg = get_config("smollm-360m").reduced()
    eng = Engine(cfg, ServeConfig(max_batch=3, max_len=32, prefill_bucket=8),
                 seed=0, device="cpu")
    eng.submit(Request(prompt=[1, 2, 3], max_new=4))
    eng.step()
    assert eng.lengths.tolist() == [4, 0, 0]
    eng.submit(Request(prompt=[4, 5, 6, 7, 8], max_new=4))
    eng.step()
    assert eng.lengths.tolist() == [5, 6, 0]


def test_engine_before_decode_sees_each_decode_step():
    """The hook runs once a batched decode, after admission, on the state
    that decode reads; re-running that decode from a copy of it gives the
    token the engine emits."""
    cfg = get_config("smollm-360m").reduced()
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=32, prefill_bucket=8),
                 seed=0, device="cpu")
    reqs = [Request(prompt=[1, 2, 3], max_new=3),
            Request(prompt=[4, 5, 6, 7, 8, 9], max_new=5),
            Request(prompt=[2, 7], max_new=2)]
    for r in reqs:
        eng.submit(r)
    seen = []

    def hook(e):
        mask = e.active.copy()
        assert mask.any() and (mask.all() or not e.queue)  # admitted
        cache = [{"attn": {n: t.clone() for n, t in c["attn"].items()}}
                 for c in e.cache]
        nxt = e.decode(e.last_tokens.clone(), e.lengths.copy(),
                       cache).argmax(-1)
        seen.append((e.decode_steps, [
            (e.slot_req[s], len(e.slot_req[s].generated), int(nxt[s]))
            for s in np.nonzero(mask)[0]]))

    eng.run_until_done(before_decode=hook)
    assert [step for step, _ in seen] == list(range(eng.decode_steps))
    for _, emits in seen:
        for req, i, tok in emits:
            assert req.generated[i] == tok
    assert eng.decode_seconds > 0
    assert eng.decode_tokens_per_s == pytest.approx(
        eng.tokens_generated / eng.decode_seconds)


# --- fc_bfp readout ---------------------------------------------------------
def test_fc_bfp_readout_matches_reference(exact_jax_exp2):  # noqa: F811
    """The untied head of reduced starcoder2-15b streamed as int8 BFP
    through kernel 4's entry, against the reference's ``fc_bfp`` readout
    (the reference's exp2 made exact, as for AlexNet's fc_bfp)."""
    j_cfg, cfg, j_params, params = _reference("starcoder2-15b", fc_bfp=True)
    assert not cfg.tie_embeddings
    toks = np.arange(1, 9)[None]
    ref, _, _ = j_lm.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32))
    bfp_ops.reset_launch_counts()
    got, _, _ = lm.apply(params, cfg, torch.from_numpy(toks))
    _close_logits(got, ref)
    f32, _, _ = lm.apply(params, dataclasses.replace(cfg, fc_bfp=False),
                         torch.from_numpy(toks))
    assert not torch.equal(got, f32)                   # the quantization ran
    assert bfp_ops.launch_counts() == {"bfp_matmul": 0}  # plain on the CPU


def test_fc_bfp_engine_tokens_match_jax_engine(exact_jax_exp2):  # noqa: F811
    _, _, (ref, got) = _serve_both(
        "starcoder2-15b", 0, dict(max_batch=2, max_len=32, prefill_bucket=8),
        [[1, 2, 3, 4], [5, 6]], 4, fc_bfp=True)
    assert got == ref


# --- launcher --------------------------------------------------------------
def test_serve_cli_lm_on_the_cpu(capsys):
    dec_ops.reset_launch_counts()
    serve.main(["--arch", "smollm-360m", "--requests", "3", "--max-new", "3",
                "--max-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    assert dec_ops.launch_counts() == {"decode_attn": 0}


@pytest.mark.parametrize("argv", [
    ["--arch", "granite-moe-1b-a400m"],
    ["--arch", "deepseek-v2-lite-16b", "--param-dtype", "bfloat16"]])
def test_serve_cli_moe_on_the_cpu(argv, capsys):
    """The MoE models through the launcher (reduced); granite's GQA decode
    takes kernel 5's plain version on the CPU, deepseek's MLA no kernel."""
    dec_ops.reset_launch_counts()
    serve.main(argv + ["--requests", "3", "--max-new", "3", "--max-len",
                       "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    dtype = "bfloat16" if "--param-dtype" in argv else "float32"
    assert f"({dtype} params, float32 activations)" in out
    assert dec_ops.launch_counts() == {"decode_attn": 0}
