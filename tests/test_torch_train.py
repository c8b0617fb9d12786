"""The port's training path against the JAX package, on the CPU.

Same numpy-made inputs on both sides, parameters carried over with
``lm.params_from_reference``; kernel 7's entry takes its plain versions on
CPU tensors (dx the forward on the reversed cotangent, dw and db the
reference's reductions).  Tolerances, each with its reason:

* kernel 7's VJP, f32: rtol 1e-3, atol 1e-4 (``tests/test_kernels.py``'s
  bound for the reference's own VJP test); bf16: dx within one bf16 step
  (both round an f32 sum once);
* flash attention: ``tests/test_flash.py``'s bounds, forward rtol 1e-4 /
  atol 1e-5, gradients rtol 1e-3 / atol 1e-4;
* ``loss_fn``: the loss within 1e-5 relative, every leaf's gradient within
  1e-4 * max|g| of that leaf (f32, summation orders differ);
* AdamW: params, m and v within 1e-6 relative;
* the data streams: bit-equal (numpy on both sides);
* remat on (either policy) against remat off: bit-equal (the same ops
  recomputed on the CPU).
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.data import pipeline as j_pipeline
from repro.kernels.conv import ops as j_conv_ops
from repro.models import lm as j_lm
from repro.nn import flash as j_flash
from repro.nn import module as j_module
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config
from repro_torch.core.streambuf import StreamBuffer
from repro_torch.data import pipeline
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.models import lm
from repro_torch.nn import flash, module
from repro_torch.optim import adamw

LM_ARCHS = ["smollm-360m", "llama3.2-3b", "starcoder2-15b", "mamba2-2.7b",
            "phi4-mini-3.8b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b"]
BF16_STEP = 2.0 ** -7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- kernel 7's VJP ---
@pytest.mark.parametrize("B,L,C", [(2, 29, 8), (2, 31, 7), (1, 10, 5),
                                   (3, 4, 130)])
def test_dw1d_vjp_matches_reference_f32(B, L, C):
    """The loss (y * sin x).sum() of ``tests/test_kernels.py``: jax.grad
    through the reference's custom VJP (its Pallas kernel in interpret
    mode) against autograd through the port's Function; odd L and C."""
    rng = np.random.default_rng(L * C)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, L, C), (4, C), (C,)))

    def f(x, w, b):
        return (j_conv_ops.conv1d_depthwise_causal(
            x, w, b, pallas=True, interpret=True) * jnp.sin(x)).sum()
    ref = jax.grad(f, argnums=(0, 1, 2))(x, w, b)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    (conv_ops.conv1d_depthwise_causal(*leaves)
     * torch.sin(leaves[0])).sum().backward()
    for t, r in zip(leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("B,L,C", [(2, 29, 8), (1, 37, 5)])
def test_dw1d_vjp_dx_matches_reference_bf16(B, L, C):
    """bf16 x and cotangent, f32 weights: the reference's dx (its kernel
    on the reversed cotangent, rounded to bf16) and the port's are within
    one bf16 step; dw and db (f32) within 1e-3 relative."""
    rng = np.random.default_rng(L + C)
    xb = np.asarray(jnp.asarray(rng.standard_normal((B, L, C)),
                                jnp.bfloat16))
    dyb = np.asarray(jnp.asarray(rng.standard_normal((B, L, C)),
                                 jnp.bfloat16))
    w = rng.standard_normal((4, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: j_conv_ops.conv1d_depthwise_causal(
        x, w, b, pallas=True, interpret=True), jnp.asarray(xb),
        jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = (np.asarray(a, np.float32)
                     for a in vjp(jnp.asarray(dyb)))
    leaves = [torch.from_numpy(xb.astype(np.float32)).bfloat16(),
              torch.from_numpy(w), torch.from_numpy(b)]
    leaves = [t.requires_grad_(True) for t in leaves]
    conv_ops.conv1d_depthwise_causal(*leaves).backward(
        torch.from_numpy(dyb.astype(np.float32)).bfloat16())
    dx = leaves[0].grad
    assert dx.dtype == torch.bfloat16
    scale = np.abs(rdx).max()
    excess = np.abs(dx.float().numpy() - rdx) - (BF16_STEP * np.abs(rdx)
                                                  + 1e-5 * scale)
    assert excess.max() <= 0
    for t, r in ((leaves[1], rdw), (leaves[2], rdb)):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max())


# --- flash attention ---
def _flash_grads(fn, arrays, **kw):
    qj, kj, vj = (jnp.asarray(a) for a in arrays)
    fj = lambda q, k, v: (j_flash.flash_attention(  # noqa: E731
        q, k, v, **kw) * jnp.cos(q)).sum()
    out_j = j_flash.flash_attention(qj, kj, vj, **kw)
    gj = jax.grad(fj, argnums=(0, 1, 2))(qj, kj, vj)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts, **kw)
    (out * torch.cos(ts[0])).sum().backward()
    return (out.detach().numpy(), np.asarray(out_j),
            [t.grad.numpy() for t in ts], [np.asarray(g) for g in gj])


FLASH_CASES = [  # (B, Sq, H, KV, D, causal, kw): tests/test_flash.py's
    (2, 64, 6, 2, 16, True, {}), (2, 50, 4, 4, 8, True, {}),
    (1, 37, 3, 1, 8, False, {}), (1, 17, 15, 5, 8, True, {}),
    (2, 64, 4, 2, 16, True, dict(banded=True)),
    (1, 50, 6, 3, 8, True, dict(banded=True)),
    (1, 48, 4, 2, 8, True, dict(banded=True, q_chunk=8)),
    (1, 40, 4, 2, 8, False, dict(kv_valid_len=29)),
]


@pytest.mark.parametrize("B,Sq,H,KV,D,causal,kw", FLASH_CASES)
def test_flash_attention_gradients_match_reference(B, Sq, H, KV, D, causal,
                                                   kw):
    """Forward and the three gradients, several tiles (q_chunk 16,
    k_chunk 32 unless the case sets them), GQA, causal and not, banded."""
    rng = np.random.default_rng(Sq * H)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Sq, KV, D), (B, Sq, KV, D))]
    kw = dict(dict(q_chunk=16, k_chunk=32), **kw, causal=causal)
    out, out_j, g, g_j = _flash_grads(flash.flash_attention, arrays, **kw)
    np.testing.assert_allclose(out, out_j, rtol=1e-4, atol=1e-5)
    for a, r in zip(g, g_j):
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=1e-4)


def test_flash_q_offset_gradients_match_reference():
    """q at an offset against a longer k/v (the prefill continuation)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
            for _ in range(2))
    out, out_j, g, g_j = _flash_grads(
        flash.flash_attention, [q, k, v], causal=True, q_offset=32,
        q_chunk=8, k_chunk=16)
    np.testing.assert_allclose(out, out_j, rtol=1e-4, atol=1e-5)
    for a, r in zip(g, g_j):
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=1e-4)


def test_flash_banded_equals_unbanded():
    """The banded schedule skips only fully masked tiles: the same bits,
    forward and backward."""
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8))]
    res = []
    for banded in (False, True):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = flash.flash_attention(*ts, causal=True, q_chunk=16,
                                    k_chunk=16, banded=banded)
        out.sum().backward()
        res.append([out.detach()] + [t.grad for t in ts])
    for a, b in zip(*res):
        assert torch.equal(a, b)


# --- loss_fn ---
def _reference(arch, seed=0, **change):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(), **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    j_params = j_lm.init(jax.random.PRNGKey(seed), j_cfg)
    return j_cfg, cfg, j_params


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :5] = -1                         # masked
    targets[1, -3:] = -7
    return {"inputs": toks[:, :-1], "targets": targets}


def _port_loss_and_grads(params, cfg, batch):
    leaves = module.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = lm.loss_fn(params, cfg, tb)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_and_gradients_match_reference(arch):
    """Reduced models (f32), some targets masked: the loss, its metrics
    and every parameter's gradient against ``jax.value_and_grad``."""
    j_cfg, cfg, j_params = _reference(arch)
    batch = _batch(cfg)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        j_lm.loss_fn, has_aux=True)(j_params, j_cfg,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    params = lm.params_from_reference(_np(j_params), cfg, device="cpu")
    loss, metrics, grads = _port_loss_and_grads(params, cfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    assert int(metrics["tokens"]) == int(j_metrics["tokens"]) == 40
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-7)
    ref_leaves = module.tree_leaves(
        lm.params_from_reference(_np(j_grads), cfg, device="cpu"))
    assert len(ref_leaves) == len(grads)
    for g, r in zip(grads, ref_leaves):
        assert g.shape == r.shape
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * scale, scale


def test_accuracy_counts_ties_and_masks():
    """A label whose logit ties the row max counts as right; masked
    targets count neither way; denom is the valid count."""
    logits = torch.tensor([[[1.0, 3.0, 3.0], [2.0, 0.0, 1.0],
                            [0.0, 5.0, 1.0]]])
    targets = torch.tensor([[2, 1, -1]])
    total, m = lm._ce(logits, targets, torch.zeros(()))
    assert int(m["tokens"]) == 2 and float(m["accuracy"]) == 0.5
    jt, jm = j_lm._ce(jnp.asarray(logits.numpy()),
                      jnp.asarray(targets.numpy()), jnp.zeros(()), None)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-6)
    assert float(jm["accuracy"]) == 0.5


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b"])
@pytest.mark.parametrize("policy", ["nothing", "save_attn"])
def test_remat_is_bit_equal_to_no_remat(arch, policy):
    """remat recomputes each layer in the backward; with save_attn the
    flash output is kept.  Loss and every gradient: the same bits."""
    j_cfg, cfg, j_params = _reference(arch)
    batch = _batch(cfg, seed=2)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        params = lm.params_from_reference(_np(j_params), c, device="cpu")
        loss, _, grads = _port_loss_and_grads(params, c, batch)
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_save_attn_skips_the_flash_recompute(monkeypatch):
    """Under save_attn the backward's recompute does not run the flash
    forward again; under "nothing" it does (once a layer)."""
    _, cfg, j_params = _reference("smollm-360m")
    batch = _batch(cfg, seed=4)
    calls = []
    real = flash._fwd
    monkeypatch.setattr(flash, "_fwd",
                        lambda *a: calls.append(1) or real(*a))
    n = {}
    for policy in ("nothing", "save_attn"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        params = lm.params_from_reference(_np(j_params), c, device="cpu")
        calls.clear()
        _port_loss_and_grads(params, c, batch)
        n[policy] = len(calls)
    assert n == {"nothing": 2 * cfg.num_layers, "save_attn": cfg.num_layers}


# --- AdamW ---
def _tree(rng):
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip_norm,wd,scale", [(1.0, 0.01, 3.0),
                                                (1.0, 0.0, 0.01),
                                                (0.0, 0.1, 1.0)])
def test_adamw_steps_match_reference(clip_norm, wd, scale):
    """Three steps (clipped and not, with and without decay) against the
    reference: params, m and v within 1e-6 relative; the grad norm."""
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    j_state = j_adamw.init_state(jax.tree_util.tree_map(jnp.asarray, p0))
    params = jax.tree_util.tree_map(torch.from_numpy, p0)
    state = adamw.init_state(params)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda a: a * scale, _tree(rng))
        lr = 1e-2 * (i + 1)
        j_state, j_om = j_adamw.adamw_step(
            j_state, jax.tree_util.tree_map(jnp.asarray, g), lr=lr,
            weight_decay=wd, clip_norm=clip_norm)
        state, om = adamw.adamw_step(
            state, jax.tree_util.tree_map(torch.from_numpy, g), lr=lr,
            weight_decay=wd, clip_norm=clip_norm)
        np.testing.assert_allclose(float(om["grad_norm"]),
                                   float(j_om["grad_norm"]), rtol=1e-6)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3
    for k in ("params", "m", "v"):
        for a, r in zip(module.tree_leaves(state[k]),
                        jax.tree_util.tree_leaves(j_state[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-12)


def test_adamw_updates_in_place():
    params = {"w": torch.ones(4)}
    state = adamw.init_state(params)
    ptrs = [state[k]["w"].data_ptr() for k in ("params", "m", "v")]
    adamw.adamw_step(state, {"w": torch.full((4,), 0.5)}, lr=0.1)
    assert [state[k]["w"].data_ptr() for k in ("params", "m", "v")] == ptrs
    assert float(params["w"][0]) < 1.0


@pytest.mark.parametrize("step", [0, 1, 7, 20, 21, 55, 100, 140])
def test_lr_schedule_matches_reference(step):
    kw = dict(base_lr=3e-3, warmup=20, total=100)
    got = float(adamw.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                  **kw))
    ref = float(j_adamw.lr_schedule(jnp.int32(step), **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_count_params_and_tree_bytes_match_reference():
    j_cfg, cfg, j_params = _reference("mamba2-2.7b")
    params = lm.params_from_reference(_np(j_params), cfg, device="cpu")
    assert module.count_params(params) == j_module.count_params(j_params)
    assert module.tree_bytes(params) == j_module.tree_bytes(j_params)


def test_reference_layout_round_trip():
    """to_reference_layout stacks the layers as the reference's init lays
    them out (names, shapes, dtypes); from_reference_layout undoes it."""
    j_cfg, cfg, j_params = _reference("llama3.2-3b")
    params = lm.params_from_reference(_np(j_params), cfg, device="cpu")
    ref = lm.to_reference_layout(params, cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(j_params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [jax.tree_util.keystr(p) for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = lm.from_reference_layout(ref, cfg)
    for a, b in zip(module.tree_leaves(back), module.tree_leaves(params)):
        assert torch.equal(a, b)


# --- data ---
@pytest.mark.parametrize("kw", [
    dict(batch=4, seq_len=16, vocab=97, seed=7, steps=3),
    dict(batch=3, seq_len=9, vocab=503, seed=2, steps=2, process_index=1,
         process_count=2),
    dict(batch=2, seq_len=8, vocab=50, seed=1, steps=2, family="audio",
         d_model=6, frames_len=5),
    dict(batch=2, seq_len=8, vocab=50, seed=1, steps=1, family="vlm",
         num_patches=3)])
def test_synthetic_batches_bit_equal(kw):
    got = list(pipeline.synthetic_batches(**kw))
    ref = list(j_pipeline.synthetic_batches(**kw))
    assert len(got) == len(ref) == kw["steps"]
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_images_bit_equal():
    kw = dict(batch=3, image_size=20, num_classes=5, seed=4, steps=2)
    for a, b in zip(pipeline.synthetic_images(**kw),
                    j_pipeline.synthetic_images(**kw)):
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --- the stream buffer ---
def test_stream_buffer_order_and_tensors():
    src = [{"inputs": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(StreamBuffer(iter(src), device="cpu"))
    assert [int(b["inputs"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["inputs"], torch.Tensor)
               and b["inputs"].dtype == torch.int32 for b in got)


def test_stream_buffer_depth_bounds_prefetch():
    """The filling thread runs at most depth + 1 batches ahead of the
    consumer (depth queued, one in hand)."""
    pulled = []

    def gen():
        for i in range(20):
            pulled.append(i)
            yield {"x": np.zeros(1, np.float32) + i}

    buf = StreamBuffer(gen(), depth=2, device="cpu")
    time.sleep(0.2)
    assert len(pulled) <= 3
    next(buf)
    time.sleep(0.2)
    assert len(pulled) <= 4


def test_stream_buffer_surfaces_errors_on_next():
    def gen():
        yield {"x": np.zeros(1, np.float32)}
        raise ValueError("bad shard")

    buf = StreamBuffer(gen(), device="cpu")
    assert float(next(buf)["x"][0]) == 0.0
    with pytest.raises(ValueError, match="bad shard"):
        next(buf)


def test_stream_buffer_put_fn_and_cuda_refused_without_card(monkeypatch):
    seen = []
    buf = StreamBuffer(iter([{"x": 1}, {"x": 2}]), device="cpu",
                       put_fn=lambda b: seen.append(
                           threading.current_thread().name) or b)
    assert [b["x"] for b in buf] == [1, 2]
    assert all(name != threading.main_thread().name for name in seen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        StreamBuffer(iter([]))
