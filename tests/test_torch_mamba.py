"""The port's Mamba-2 LM (reduced mamba2-2.7b) and its token Engine against
the JAX package.

Weights carried over from the reference with ``lm.params_from_reference``,
the same numpy-made tokens on both sides, all on the CPU (kernels 6 and 7
take their plain versions there).  Tolerances: logits within 1e-4 *
max|logit| in f32 (summation orders differ), caches 1e-4, the Engine's
greedy tokens exactly.  Prompts shorter than the conv window (k - 1 = 3
tokens) are where the reference keeps a short conv cache (ROADMAP Queue
3); the port's is held to the causal conv's own definition instead.
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
from repro.nn import ssd as j_nn_ssd
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import lm, model_for
from repro_torch.nn import layers, ssd
from repro_torch.serving import Engine, Request, ServeConfig

ARCH = "mamba2-2.7b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(seed=0):
    j_cfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    j_params = j_lm.init(jax.random.PRNGKey(seed), j_cfg)
    params = lm.params_from_reference(_np(j_params), cfg, device="cpu")
    return j_cfg, cfg, j_params, params


def _caches_from_reference(j_caches, cfg):
    return lm.params_from_reference({"stack": _np(j_caches)}, cfg,
                                    device="cpu")["stack"]


def _zeros(j_cfg, batch, max_len):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_lm.cache_shape(j_cfg, batch, max_len))


def _close_logits(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


# --- config and dispatch -------------------------------------------------------
def test_config_matches_reference():
    for full in (True, False):
        j_cfg, cfg = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j_cfg, cfg = j_cfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
        assert (cfg.d_inner, cfg.ssm_heads) == (j_cfg.d_inner,
                                                j_cfg.ssm_heads)
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [j_cfg.layer_kind(i) for i in range(j_cfg.num_layers)]
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm.d_state, full.ssm.chunk) == (64, 2560, 5120, 80, 128,
                                                  256)
    assert ARCH in LM_ARCHS


def test_ssm_family_is_the_lm_and_hybrid_still_raises():
    """The SSM family and the hybrid (no longer refused since item 7c)
    are both the LM."""
    assert model_for(get_config(ARCH)) is lm
    assert model_for(dataclasses.replace(get_config(ARCH),
                                         family="hybrid")) is lm


def test_init_and_caches_match_reference_structure():
    j_cfg, cfg, _, carried = _reference()
    mine = lm.init(0, cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(carried)[0]]
    caches = lm.cache_init(cfg, 3, 32, device="cpu")
    want = _caches_from_reference(_zeros(j_cfg, 3, 32), cfg)
    assert [{n: tuple(t.shape) for n, t in c["ssm"].items()}
            for c in caches] == \
        [{n: tuple(t.shape) for n, t in c["ssm"].items()} for c in want]


# --- the model ----------------------------------------------------------------
def _apply_both(mode):
    j_cfg, cfg, j_params, params = _reference()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))     # two 16-token chunks
    if mode == "train":
        ref, _, _ = j_lm.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32))
        got, _, _ = lm.apply(params, cfg, torch.from_numpy(toks))
        return got, ref, None, None, cfg
    ref, j_caches, _ = j_lm.apply(j_params, j_cfg,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill",
                                  caches=_zeros(j_cfg, 2, 32))
    if mode == "prefill":
        got, caches, _ = lm.apply(params, cfg, torch.from_numpy(toks),
                                  mode="prefill",
                                  caches=lm.cache_init(cfg, 2, 32,
                                                       device="cpu"))
        return got, ref, caches, j_caches, cfg
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    lens = np.array([21, 21], np.int32)
    caches = _caches_from_reference(j_caches, cfg)
    ref, j_caches, _ = j_lm.apply(j_params, j_cfg,
                                  jnp.asarray(new, jnp.int32), mode="decode",
                                  length=jnp.asarray(lens), caches=j_caches)
    got, caches, _ = lm.apply(params, cfg, torch.from_numpy(new),
                              mode="decode", length=torch.from_numpy(lens),
                              caches=caches)
    return got, ref, caches, j_caches, cfg


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_matches_reference(mode):
    """Logits in all three modes and the caches prefill and decode leave;
    prefill and train run kernels 7 and 6's entries (plain on the CPU)."""
    ssd_ops.reset_launch_counts()
    got, ref, caches, j_caches, cfg = _apply_both(mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close_logits(got, ref)
    assert ssd_ops.launch_counts() == {"ssd": 0}
    if caches is not None:
        want = _caches_from_reference(j_caches, cfg)
        for have, ref_layer in zip(caches, want):
            assert set(have) == {"ssm"}
            for name, t in have["ssm"].items():
                np.testing.assert_allclose(t.numpy(),
                                           ref_layer["ssm"][name].numpy(),
                                           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_kernel_route_is_no_further_from_f32_than_plain_route(
        seed, monkeypatch):
    """The served route (kernels 7 and 6, f32 inside) and the plain route
    (``pallas=False``: the Winograd in x's dtype, the scan's roundings to
    x's dtype) are one function with f32 activations (1e-4 * max|logit|);
    with bf16 activations the kernels' logits are no further from the f32
    model's than the plain route's are.  The full-width prefill on the
    card is held to the same two conditions (``chip_smoke.py``)."""
    import functools
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm.init(seed, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (2, 40)))

    def prefill(c):
        return lm.apply(params, c, toks, mode="prefill",
                        caches=lm.cache_init(c, 2, 64, device="cpu"))[0]

    kern, kern32 = prefill(cfg), prefill(cfg32)
    monkeypatch.setattr(ssd_ops, "ssd_chunked", functools.partial(
        ssd_ops.ssd_chunked, pallas=False))
    monkeypatch.setattr(conv_ops, "conv1d_depthwise_causal",
                        functools.partial(conv_ops.conv1d_depthwise_causal,
                                          pallas=False))
    plain, plain32 = prefill(cfg), prefill(cfg32)
    lmax = float(plain32.abs().max())
    assert float((kern32 - plain32).abs().max()) <= 1e-4 * lmax
    err_k = float((kern - plain32).abs().max())
    err_p = float((plain - plain32).abs().max())
    assert 0 < err_k <= err_p


# --- the Engine ---------------------------------------------------------------
def _serve_both(prompts, max_new, **skw):
    j_cfg, cfg, _, _ = _reference()
    j_eng = JEngine(j_cfg, JServeConfig(**skw), seed=1)
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


def test_engine_tokens_match_jax_engine():
    """Mixed prompt lengths of 3 or more tokens (one over a 16-token
    chunk), more requests than slots: exact-length prefills, slot reuse,
    batched decode of the SSM state."""
    prompts = [list(range(1, n + 1)) for n in (5, 3, 19, 8, 4)]
    j_eng, eng, (ref, got) = _serve_both(prompts, 4, max_batch=2,
                                         max_len=48)
    assert got == ref
    assert eng.decode_steps == j_eng.decode_steps
    assert eng.tokens_generated == j_eng.tokens_generated


def test_engine_prefills_at_exact_length():
    cfg = get_config(ARCH).reduced()
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=64,
                                  prefill_bucket=16), seed=0, device="cpu")
    assert [eng._pad_len(n) for n in (1, 5, 17)] == [1, 5, 17]


def test_engine_insert_copies_every_ssm_cache():
    """After admission the slot holds the one-row prefill's conv windows
    and state; the other slot keeps its zeros."""
    j_cfg, cfg, _, params = _reference()
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=32), params=params,
                 device="cpu")
    prompt = [7, 3, 9, 4, 2]
    eng.submit(Request(prompt=prompt, max_new=3))
    eng._admit()
    one = lm.cache_init(cfg, 1, 32, device="cpu")
    lm.apply(params, cfg, torch.tensor([prompt]), mode="prefill",
             caches=one)
    for full, row in zip(eng.cache, one):
        for name, buf in full["ssm"].items():
            assert torch.equal(buf[0], row["ssm"][name][0])
            assert not buf[1].any()


# --- prompts shorter than the conv window ------------------------------------
def _raw_x0(params, cfg, toks):
    """Layer 0's x stream before its conv: the raw inputs its conv cache
    holds."""
    h = layers.embed(params["embed"], toks, torch.float32)
    h = layers.norm(cfg.norm_type, params["stack"][0]["norm1"], h)
    return layers.linear(params["stack"][0]["ssm"]["wx"], h)


@pytest.mark.parametrize("plen", [1, 2, 3])
def test_short_prompt_conv_cache_is_zero_padded(plen):
    """After a prompt of plen < k - 1 tokens the conv cache is the prompt's
    raw inputs behind k - 1 - plen zero rows (layer 0's checked by value,
    every layer's zeros), and plen tokens of prefill plus one decode step
    give the logits and state of a prefill of plen + 1 tokens."""
    _, cfg, _, params = _reference()
    rng = np.random.default_rng(plen)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, plen + 1)))
    k1 = cfg.ssm.conv_kernel - 1
    caches = lm.cache_init(cfg, 1, 16, device="cpu")
    lm.apply(params, cfg, toks[:, :plen], mode="prefill", caches=caches)
    raw = _raw_x0(params, cfg, toks[:, :plen])
    conv_x = caches[0]["ssm"]["conv_x"]
    assert conv_x.shape == (1, k1, cfg.d_inner)
    np.testing.assert_allclose(conv_x[:, k1 - plen:].numpy(), raw.numpy(),
                               rtol=1e-6, atol=1e-6)
    for c in caches:
        for name in ("conv_x", "conv_b", "conv_c"):
            assert not c["ssm"][name][:, :k1 - plen].any()
    step, caches, _ = lm.apply(params, cfg, toks[:, plen:], mode="decode",
                               length=torch.tensor([plen]), caches=caches)
    whole = lm.cache_init(cfg, 1, 16, device="cpu")
    full, whole, _ = lm.apply(params, cfg, toks, mode="prefill",
                              caches=whole)
    _close_logits(step[:, 0], full[:, -1].numpy())
    for a, b in zip(caches, whole):
        for name, t in a["ssm"].items():
            np.testing.assert_allclose(t.numpy(), b["ssm"][name].numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plen", [1, 2])
def test_reference_keeps_a_short_conv_cache(plen):
    """The fault the port does not copy: the reference's prefill of a
    prompt shorter than k - 1 = 3 tokens slices raw[:, S - (k - 1):] from
    a negative start, so its conv cache has one row, not three
    (``repro/nn/ssd.py`` mamba_apply); its Engine writes that row into row
    0 of the slot and leaves rows 1-2 as they were."""
    j_cfg = j_get_config(ARCH).reduced()
    p = j_nn_ssd.mamba_init(jax.random.PRNGKey(0), j_cfg)
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   j_nn_ssd.ssm_cache_shape(j_cfg, 1))
    x = jnp.ones((1, plen, j_cfg.d_model), jnp.float32)
    _, new = j_nn_ssd.mamba_apply(p, j_cfg, x, mode="prefill", cache=cache)
    assert cache["conv_x"].shape == (1, 3, j_cfg.d_inner)
    assert new["conv_x"].shape == (1, 1, j_cfg.d_inner)
    assert ssd.conv_tail(torch.ones((1, plen, 5)), 4).shape == (1, 3, 5)


# --- launcher ---------------------------------------------------------------
def test_serve_cli_mamba_on_the_cpu(capsys):
    ssd_ops.reset_launch_counts()
    conv_ops.reset_launch_counts()
    serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "3",
                "--max-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    assert ssd_ops.launch_counts() == {"ssd": 0}
    assert conv_ops.launch_counts()["dw1d"] == 0
