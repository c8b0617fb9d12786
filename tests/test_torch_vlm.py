"""The port's vision-language model (``models/vlm.py``) and its token Engine
against the JAX package, on reduced phi-3-vision-4.2b.

Same numpy-made inputs on both sides, the reference's parameters carried
over with ``vlm.params_from_reference``, all on the CPU (kernel 5 takes
its plain version there).  Tolerances: 1e-5 * max|y| in f32 (``apply``'s
logits and caches, the prefill/decode against teacher forcing;
summation orders differ), 5e-2 * max|y| in bf16; ``loss_fn`` 1e-5
relative and every gradient within 1e-4 * max|g| of its leaf
(``tests/test_torch_train.py``'s bound); the Engine's greedy tokens
exactly.  Engine parity uses text lengths under ``max_len -
num_patches``: past that the reference retires a request early (ROADMAP
Queue 3), and the port does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import vlm as j_vlm
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.launch import serve
from repro_torch.models import lm, model_for, vlm
from repro_torch.nn import module
from repro_torch.serving import Engine, Request, ServeConfig

ARCH = "phi-3-vision-4.2b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(seed=0, **change):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(), **change)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **change)
    j_params = j_vlm.init(jax.random.PRNGKey(seed), j_cfg)
    params = vlm.params_from_reference(_np(j_params), cfg, device="cpu")
    return j_cfg, cfg, j_params, params


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    got = got.float().detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _j_zeros(j_cfg, B, L):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_vlm.cache_shape(j_cfg, B, L))


def _caches_from_reference(j_caches, cfg):
    return lm.params_from_reference({"stack": _np(j_caches)}, cfg,
                                    device="cpu")["stack"]


# --- configs and dispatch ----------------------------------------------------
@pytest.mark.parametrize("full", [True, False])
def test_config_matches_reference(full):
    j_cfg, cfg = j_get_config(ARCH), get_config(ARCH)
    if not full:
        j_cfg, cfg = j_cfg.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert model_for(cfg) is vlm
    assert vlm.CLIP_DIM == j_vlm.CLIP_DIM == 1024
    if full:    # MHA with 96-wide heads: kernel 5's D = 96, G = 1
        assert (cfg.d_head, cfg.num_heads // cfg.num_kv_heads,
                cfg.num_patches) == (96, 1, 576)


def test_init_matches_reference_structure():
    cfg = get_config(ARCH).reduced()
    _, _, _, carried = _reference()
    mine = vlm.init(0, cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(carried)[0]]
    assert tuple(mine["patch_proj"]["w"].shape) == (1024, cfg.d_model)


def test_cache_covers_the_patch_prefix():
    cfg = get_config(ARCH).reduced()
    shapes = vlm.cache_shape(cfg, 2, 20)
    assert [c["attn"]["k"][0] for c in shapes] == \
        [(2, cfg.num_patches + 20, cfg.num_kv_heads, cfg.d_head)] * \
        cfg.num_layers
    j_shapes = j_vlm.cache_shape(j_get_config(ARCH).reduced(), 2, 20)
    assert j_shapes["scan"]["b0"]["attn"]["k"].shape[1:] == \
        shapes[0]["attn"]["k"][0]


# --- the model ---------------------------------------------------------------
def _apply_both(mode, dtype="float32"):
    j_cfg, cfg, j_params, params = _reference(dtype=dtype)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    pa = _x((2, cfg.num_patches, 1024), 6, 0.1)
    jt = jnp.asarray(toks, jnp.int32)
    if mode == "train":
        ref, _, _ = j_vlm.apply(j_params, j_cfg, jt, patches=jnp.asarray(pa))
        got, _, _ = vlm.apply(params, cfg, torch.from_numpy(toks),
                              patches=torch.from_numpy(pa))
        return got, ref, None, None
    L = 24
    ref, j_caches, _ = j_vlm.apply(j_params, j_cfg, jt,
                                   patches=jnp.asarray(pa), mode="prefill",
                                   caches=_j_zeros(j_cfg, 2, L))
    if mode == "prefill":
        got, caches, _ = vlm.apply(params, cfg, torch.from_numpy(toks),
                                   patches=torch.from_numpy(pa),
                                   mode="prefill",
                                   caches=vlm.cache_init(cfg, 2, L,
                                                         device="cpu"))
        return got, ref, caches, j_caches
    # one token a slot at ragged offsets past the patch prefix
    lens = cfg.num_patches + np.array([11, 6], np.int32)
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    caches = _caches_from_reference(j_caches, cfg)
    ref, j_caches, _ = j_vlm.apply(j_params, j_cfg,
                                   jnp.asarray(new, jnp.int32),
                                   mode="decode", length=jnp.asarray(lens),
                                   caches=j_caches)
    got, caches, _ = vlm.apply(params, cfg, torch.from_numpy(new),
                               mode="decode", length=torch.from_numpy(lens),
                               caches=caches)
    return got, ref, caches, j_caches


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_matches_reference(mode):
    """Logits (token positions only) in all three modes, and the caches
    (patch prefix and text) that prefill and decode leave."""
    got, ref, caches, j_caches = _apply_both(mode)
    cfg = get_config(ARCH).reduced()
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert got.shape[1] == (11 if mode != "decode" else 1)
    _close(got, ref)
    if caches is not None:
        want = _caches_from_reference(j_caches, cfg)
        assert len(caches) == len(want)
        for have, r in zip(caches, want):
            assert set(have) == {"attn"} and set(have["attn"]) == {"k", "v"}
            for name in ("k", "v"):
                np.testing.assert_allclose(have["attn"][name].numpy(),
                                           r["attn"][name].numpy(),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_apply_bf16_matches_reference(mode):
    """bf16 activations (f32 parameters): the patches cast to bf16 before
    the projection, as in the reference."""
    got, ref, _, _ = _apply_both(mode, dtype="bfloat16")
    _close(got, ref, 5e-2)


def test_apply_without_patches_is_the_text_model():
    j_cfg, cfg, j_params, params = _reference()
    toks = np.arange(1, 10)[None]
    ref, _, _ = j_vlm.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32))
    got, _, _ = vlm.apply(params, cfg, torch.from_numpy(toks))
    _close(got, ref)
    with_p, _, _ = vlm.apply(params, cfg, torch.from_numpy(toks),
                             patches=torch.ones(1, cfg.num_patches, 1024))
    assert not torch.allclose(got, with_p)


def test_prefill_decode_matches_teacher_forcing():
    """The port's version of the reference's test: a decode's length
    counts the patch prefix."""
    _, cfg, _, params = _reference()
    B, S, dec = 2, 24, 3
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + dec)))
    pa = torch.from_numpy(
        (rng.standard_normal((B, cfg.num_patches, 1024)) * 0.1).astype(
            np.float32))
    with torch.no_grad():
        full, _, _ = vlm.apply(params, cfg, toks, patches=pa)
        lp, cache, _ = vlm.apply(params, cfg, toks[:, :S], patches=pa,
                                 mode="prefill",
                                 caches=vlm.cache_init(cfg, B, S + dec,
                                                       device="cpu"))
        _close(lp, full[:, :S].numpy())
        for i in range(dec):
            ld, cache, _ = vlm.apply(
                params, cfg, toks[:, S + i:S + i + 1], mode="decode",
                length=torch.tensor(cfg.num_patches + S + i), caches=cache)
            _close(ld[:, 0], full[:, S + i].numpy())


def test_loss_fn_and_gradients_match_reference():
    """Some targets masked: the loss, its metrics and every parameter's
    gradient, ``patch_proj``'s too, against ``jax.value_and_grad``."""
    j_cfg, cfg, j_params, params = _reference()
    rng = np.random.default_rng(3)
    tgt = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    tgt[1, 4:] = -1
    batch = {"patches": _x((2, cfg.num_patches, 1024), 4, 0.1),
             "inputs": rng.integers(0, cfg.vocab_size, (2, 10)).astype(
                 np.int32),
             "targets": tgt}
    (j_loss, j_m), j_grads = jax.value_and_grad(
        j_vlm.loss_fn, has_aux=True)(
        j_params, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = module.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, m = vlm.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    assert int(m["tokens"]) == int(j_m["tokens"]) == 14
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(j_m[k]),
                                   rtol=1e-5, atol=1e-7)
    ref = module.tree_leaves(vlm.params_from_reference(
        _np(j_grads), cfg, device="cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
    i = next(i for i, t in enumerate(leaves)
             if t is params["patch_proj"]["w"])
    assert float(grads[i].abs().max()) > 0


# --- the Engine --------------------------------------------------------------
def _greedy(params, cfg, prompt, patches, n):
    toks = list(prompt)
    pa = None if patches is None else torch.from_numpy(patches)[None]
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = vlm.apply(params, cfg, torch.tensor([toks]),
                                     patches=pa)
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("with_patches", [True, False])
def test_engine_tokens_match_jax_engine(with_patches):
    """Prompts of 5-20 tokens over 2 slots, text lengths under max_len -
    num_patches; patches of 0.1 * N(0, 1), or none (both engines' zeros)."""
    j_cfg, cfg, _, _ = _reference()
    skw = dict(max_batch=2, max_len=48, prefill_bucket=8)
    j_eng = JEngine(j_cfg, JServeConfig(**skw), seed=1)
    eng = Engine(cfg, ServeConfig(**skw), device="cpu",
                 params=vlm.params_from_reference(_np(j_eng.params), cfg,
                                                  device="cpu"))
    prompts = [[(11 * i + 5) % 503 + 1 for i in range(n)]
               for n in (5, 17, 20, 9)]
    out = []
    for e, req in ((j_eng, JRequest), (eng, Request)):
        reqs = [req(prompt=p, max_new=5, patches=_x(
            (cfg.num_patches, 1024), 40 + i, 0.1) if with_patches else None)
            for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done and len(r.generated) == 5 for r in reqs)
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    assert eng.decode_steps == j_eng.decode_steps


def test_engine_slot_length_counts_the_patch_prefix():
    cfg = get_config(ARCH).reduced()
    eng = Engine(cfg, ServeConfig(max_batch=2, max_len=32,
                                  prefill_bucket=8), seed=0, device="cpu")
    eng.submit(Request(prompt=[1, 2, 3], max_new=4))
    eng.step()
    assert eng.lengths.tolist() == [cfg.num_patches + 4, 0]


def test_reference_vlm_retires_after_two_tokens():
    """ROADMAP Queue 3: with num_patches 40 > max_len 32 the reference's
    retire test (length >= max_len - 1, the length counting the patch
    prefix) ends every request after 2 of its 8 tokens.  The port counts
    text positions: all 8, and they are greedy teacher forcing's."""
    change = dict(num_patches=40)
    j_cfg, cfg, _, _ = _reference(**change)
    skw = dict(max_batch=2, max_len=32, prefill_bucket=8)
    j_eng = JEngine(j_cfg, JServeConfig(**skw), seed=2)
    params = vlm.params_from_reference(_np(j_eng.params), cfg, device="cpu")
    eng = Engine(cfg, ServeConfig(**skw), device="cpu", params=params)
    prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
    got = {}
    for name, e, req in (("ref", j_eng, JRequest), ("port", eng, Request)):
        reqs = [req(prompt=p, max_new=8,
                    patches=_x((40, 1024), 50 + i, 0.1))
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done for r in reqs)
        got[name] = reqs
    assert [len(r.generated) for r in got["ref"]] == [2, 2]
    assert [len(r.generated) for r in got["port"]] == [8, 8]
    for r, j in zip(got["port"], got["ref"]):
        assert r.generated[:2] == j.generated
        assert r.generated == _greedy(params, cfg, r.prompt, r.patches, 8)


def test_serve_cli_on_the_cpu(capsys):
    """The launcher's request shapes (the config's patches, 0.1 * N(0,
    1)) on reduced phi-3-vision-4.2b; kernel 5's plain version."""
    dec_ops.reset_launch_counts()
    serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "3",
                "--max-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    assert dec_ops.launch_counts() == {"decode_attn": 0}
