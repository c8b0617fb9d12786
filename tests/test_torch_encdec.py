"""The port's cross-attention, encoder-decoder (``models/encdec.py``) and its
token Engine against the JAX package, on reduced whisper-tiny.

Same numpy-made inputs on both sides, the reference's parameters carried
over with ``encdec.params_from_reference``, all on the CPU (kernel 5
takes its plain version there).  Tolerances: 1e-5 * max|y| in f32 (the
layer, ``encode``, ``apply``'s logits and caches, the prefill/decode
against teacher forcing; summation orders differ), 5e-2 * max|y| in
bf16; ``loss_fn`` 1e-5 relative and every gradient within 1e-4 * max|g|
of its leaf (``tests/test_torch_train.py``'s bound: sums over the batch
in other orders); the Engine's greedy tokens exactly.

The port's cross cache has one more leaf than the reference's, ``clen``
(the encoder rows each slot's prefill wrote): cache comparisons take
``ck`` / ``cv`` by name and check ``clen`` apart.  The cross decode
masks to ``clen``; the reference attends to every ``cross_len`` row
(ROADMAP Queue 3), so the two agree where the frames fill ``cross_len``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import encdec as j_encdec
from repro.nn import attention as j_attn
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.launch import serve
from repro_torch.models import encdec, lm, model_for
from repro_torch.nn import attention, module
from repro_torch.serving import Engine, Request, ServeConfig

ARCH = "whisper-tiny"
CROSS = 16                   # the reference test's cross_len


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(seed=0, **change):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(), **change)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **change)
    j_params = j_encdec.init(jax.random.PRNGKey(seed), j_cfg)
    params = encdec.params_from_reference(_np(j_params), cfg, device="cpu")
    return j_cfg, cfg, j_params, params


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    got = got.float().detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _j_zeros(j_cfg, B, L, cross_len=CROSS):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  j_encdec.cache_shape(j_cfg, B, L,
                                                       cross_len))


def _caches_from_reference(j_caches, cfg, clen):
    """The reference's scan-stacked caches as the port's per-layer list,
    with the port's ``clen`` leaf set to ``clen`` rows."""
    caches = lm.params_from_reference({"stack": _np(j_caches)}, cfg,
                                      device="cpu")["stack"]
    for c in caches:
        B = c["xattn"]["ck"].shape[0]
        c["xattn"]["clen"] = torch.full((B,), clen, dtype=torch.int32)
    return caches


def _check_caches(caches, j_caches, cfg, clen):
    want = _caches_from_reference(j_caches, cfg, clen)
    assert len(caches) == len(want) == cfg.num_layers
    for have, ref in zip(caches, want):
        assert set(have) == set(ref) == {"attn", "xattn"}
        assert set(have["attn"]) == {"k", "v"}
        assert set(have["xattn"]) == {"ck", "cv", "clen"}
        for kind, names in (("attn", ("k", "v")), ("xattn", ("ck", "cv"))):
            for name in names:
                np.testing.assert_allclose(have[kind][name].numpy(),
                                           ref[kind][name].numpy(),
                                           rtol=1e-5, atol=1e-5)
        assert have["xattn"]["clen"].tolist() == [clen] * len(
            have["xattn"]["clen"])


# --- configs and dispatch ----------------------------------------------------
@pytest.mark.parametrize("full", [True, False])
def test_config_matches_reference(full):
    j_cfg, cfg = j_get_config(ARCH), get_config(ARCH)
    if not full:
        j_cfg, cfg = j_cfg.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
        [j_cfg.layer_kind(i) for i in range(j_cfg.num_layers)]
    assert model_for(cfg) is encdec
    assert dataclasses.asdict(encdec.enc_cfg(cfg)) == \
        dataclasses.asdict(j_encdec.enc_cfg(j_cfg))


def test_init_matches_reference_structure():
    """The port's init draws the reference's tree (encoder and decoder
    stacks one dict a layer, each decoder layer with ``normx`` and
    ``xattn``), shapes and dtypes."""
    cfg = get_config(ARCH).reduced()
    _, _, _, carried = _reference()
    mine = encdec.init(0, cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape), v.dtype) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape), v.dtype) for k, v in flat(carried)[0]]
    assert len(mine["enc_stack"]) == cfg.encoder_layers
    assert all({"normx", "xattn"} <= set(layer)
               for layer in mine["dec_stack"])
    assert not any("xattn" in layer for layer in mine["enc_stack"])


def test_cache_shape_has_the_cross_cache():
    cfg = get_config(ARCH).reduced()
    shapes = encdec.cache_shape(cfg, 3, 20, cross_len=CROSS)
    j_shapes = j_encdec.cache_shape(j_get_config(ARCH).reduced(), 3, 20,
                                    CROSS)
    KV, D = cfg.num_kv_heads, cfg.d_head
    for c in shapes:
        assert c["attn"]["k"][0] == (3, 20, KV, D)
        assert c["xattn"]["ck"][0] == c["xattn"]["cv"][0] == (3, CROSS, KV, D)
        assert c["xattn"]["clen"] == ((3,), torch.int32)
    assert j_shapes["scan"]["b0"]["xattn"]["ck"].shape[1:] == \
        (3, CROSS, KV, D)
    assert encdec.CROSS_LEN_DEFAULT == j_encdec.CROSS_LEN_DEFAULT == 1500
    zero = encdec.cache_init(cfg, 2, 8, cross_len=4, device="cpu")
    assert zero[0]["xattn"]["clen"].tolist() == [0, 0]
    # one attention layer's cache with the cross entries, as the
    # reference's attn_cache_shape(cross_len=) gives it, and clen
    one = attention.attn_cache_shape(cfg, 3, 20, cross_len=CROSS)
    j_one = j_attn.attn_cache_shape(j_get_config(ARCH).reduced(), 3, 20,
                                    cross_len=CROSS)
    assert set(one) == set(j_one) | {"clen"}
    assert all(one[n][0] == j_one[n].shape for n in j_one)


# --- the cross-attention layer -----------------------------------------------
def _cross_layer(dtype="float32", seed=0):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    j_p = _np(j_attn.attn_init(jax.random.PRNGKey(seed), j_cfg, cross=True))
    return j_cfg, cfg, j_p, lm._tensors(j_p, "cpu")


DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,cross", [("train", True), ("bidir", True),
                                        ("prefill", True), ("bidir", False)])
def test_cross_layer_matches_reference(mode, cross, dtype):
    """q from x, K and V from enc_out, no RoPE, not causal (train, bidir,
    prefill with no cache); bidir without enc_out: non-causal
    self-attention with RoPE (the encoder's)."""
    j_cfg, cfg, j_p, p = _cross_layer(dtype)
    jx, x = _pair(_x((2, 7, cfg.d_model), 1), dtype)
    je, e = _pair(_x((2, 11, cfg.d_model), 2), dtype)
    kw = {"enc_out": e} if cross else {}
    jkw = {"enc_out": je} if cross else {}
    ref, _ = j_attn.attn_apply(j_p, j_cfg, jx, mode=mode, **jkw)
    got, _ = attention.attn_apply(p, cfg, x, mode=mode, **kw)
    assert got.dtype == x.dtype
    _close(got, ref, DTYPES[dtype][2])


def test_bidir_is_not_causal_and_cross_ignores_order():
    """bidir sees later positions (a change at the last position moves
    the first output) and differs from causal train; the cross output
    does not depend on the order of the encoder's rows."""
    _, cfg, _, p = _cross_layer()
    x = torch.from_numpy(_x((1, 6, cfg.d_model), 3))
    x2 = x.clone()
    x2[0, -1] += 1.0
    a, _ = attention.gqa_apply(p, cfg, x, mode="bidir")
    b, _ = attention.gqa_apply(p, cfg, x2, mode="bidir")
    c, _ = attention.gqa_apply(p, cfg, x, mode="train")
    assert not torch.allclose(a[0, 0], b[0, 0])
    assert not torch.allclose(a[0, :-1], c[0, :-1])
    e = torch.from_numpy(_x((1, 9, cfg.d_model), 4))
    y, _ = attention.gqa_apply(p, cfg, x, mode="train", enc_out=e)
    y2, _ = attention.gqa_apply(p, cfg, x, mode="train",
                                enc_out=e.flip(1))
    torch.testing.assert_close(y, y2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [CROSS, 9])
def test_cross_prefill_and_decode_match_reference(T):
    """Prefill with enc_out writes ck / cv from row 0 and ``clen`` = T;
    the cross decode (a cache with no ``k``) is kernel 5's entry over the
    T written rows.  T = cross_len: the reference's cross decode on the
    same cache; T < cross_len: the reference's decode over the T written
    rows (its own decode attends to all cross_len rows)."""
    j_cfg, cfg, j_p, p = _cross_layer()
    B = 3
    x = _x((B, 5, cfg.d_model), 5)
    e = _x((B, T, cfg.d_model), 6)
    shapes = attention.cross_cache_shape(cfg, B, CROSS)
    cache = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in shapes.items()}
    j_cache = {"ck": jnp.zeros(shapes["ck"][0]),
               "cv": jnp.zeros(shapes["cv"][0])}
    ref, j_cache = j_attn.attn_apply(j_p, j_cfg, jnp.asarray(x),
                                     mode="prefill", cache=j_cache,
                                     enc_out=jnp.asarray(e))
    got, cache = attention.attn_apply(p, cfg, torch.from_numpy(x),
                                      mode="prefill", cache=cache,
                                      enc_out=torch.from_numpy(e))
    _close(got, ref)
    for n in ("ck", "cv"):
        _close(cache[n], j_cache[n])
    assert cache["clen"].tolist() == [T] * B
    assert not cache["ck"][:, T:].any()
    q = _x((B, 1, cfg.d_model), 7)
    j_read = {n: j_cache[n][:, :T] for n in ("ck", "cv")}
    ref, _ = j_attn.attn_apply(j_p, j_cfg, jnp.asarray(q), mode="decode",
                               length=jnp.int32(3), cache=j_read)
    got, cache2 = attention.attn_apply(p, cfg, torch.from_numpy(q),
                                       mode="decode", length=3, cache=cache)
    assert cache2 is cache
    _close(got, ref)
    # q gets no RoPE: the position does not move the cross decode
    again, _ = attention.attn_apply(p, cfg, torch.from_numpy(q),
                                    mode="decode", length=11, cache=cache)
    assert torch.equal(got, again)


def test_cross_decode_masks_each_slot_to_its_rows():
    """Slots whose ``clen`` differ: each slot's output equals a decode over
    its own rows alone, whatever the rows past them hold."""
    _, cfg, _, p = _cross_layer()
    B, L = 3, 12
    shapes = attention.cross_cache_shape(cfg, B, L)
    rng = np.random.default_rng(8)
    cache = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, (s, _) in shapes.items() if n != "clen"}
    cache["clen"] = torch.tensor([12, 5, 1], dtype=torch.int32)
    q = torch.from_numpy(_x((B, 1, cfg.d_model), 9))
    got, _ = attention.gqa_apply(p, cfg, q, mode="decode", cache=cache)
    for b, n in enumerate((12, 5, 1)):
        alone = {"ck": cache["ck"][b:b + 1, :n].contiguous(),
                 "cv": cache["cv"][b:b + 1, :n].contiguous(),
                 "clen": torch.tensor([n], dtype=torch.int32)}
        one, _ = attention.gqa_apply(p, cfg, q[b:b + 1], mode="decode",
                                     cache=alone)
        torch.testing.assert_close(got[b:b + 1], one, rtol=1e-5, atol=1e-6)


# --- the model ---------------------------------------------------------------
def test_encode_matches_reference():
    j_cfg, cfg, j_params, params = _reference()
    fr = _x((2, 13, cfg.d_model), 10, 0.1)
    ref = j_encdec.encode(j_params, j_cfg, jnp.asarray(fr))
    got = encdec.encode(params, cfg, torch.from_numpy(fr))
    _close(got, ref)


def _apply_both(mode):
    j_cfg, cfg, j_params, params = _reference()
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    fr = _x((2, CROSS, cfg.d_model), 12, 0.1)
    jt = jnp.asarray(toks, jnp.int32)
    if mode == "train":
        ref, _, _ = j_encdec.apply(j_params, j_cfg, jt,
                                   frames=jnp.asarray(fr))
        got, _, _ = encdec.apply(params, cfg, torch.from_numpy(toks),
                                 frames=torch.from_numpy(fr))
        return cfg, got, ref, None, None
    L = 24
    ref, j_caches, _ = j_encdec.apply(j_params, j_cfg, jt,
                                      frames=jnp.asarray(fr),
                                      mode="prefill",
                                      caches=_j_zeros(j_cfg, 2, L))
    if mode == "prefill":
        got, caches, _ = encdec.apply(
            params, cfg, torch.from_numpy(toks), frames=torch.from_numpy(fr),
            mode="prefill",
            caches=encdec.cache_init(cfg, 2, L, cross_len=CROSS,
                                     device="cpu"))
        return cfg, got, ref, caches, j_caches
    # decode one token a slot at ragged offsets from the reference's cache
    lens = np.array([11, 6], np.int32)
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    caches = _caches_from_reference(j_caches, cfg, CROSS)
    ref, j_caches, _ = j_encdec.apply(j_params, j_cfg,
                                      jnp.asarray(new, jnp.int32),
                                      mode="decode",
                                      length=jnp.asarray(lens),
                                      caches=j_caches)
    got, caches, _ = encdec.apply(params, cfg, torch.from_numpy(new),
                                  mode="decode",
                                  length=torch.from_numpy(lens),
                                  caches=caches)
    return cfg, got, ref, caches, j_caches


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_matches_reference(mode):
    """Logits in all three modes; the self and cross caches that prefill
    and decode leave, by name."""
    cfg, got, ref, caches, j_caches = _apply_both(mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close(got, ref)
    if caches is not None:
        _check_caches(caches, j_caches, cfg, CROSS)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_apply_bf16_matches_reference(mode):
    """bf16 activations (f32 parameters): frames cast to bf16 before the
    encoder, as in the reference."""
    j_cfg, cfg, j_params, params = _reference(dtype="bfloat16")
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 9))
    fr = _x((2, CROSS, cfg.d_model), 15, 0.1)
    kw = {} if mode == "train" else {"caches": None}
    ref, _, _ = j_encdec.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32),
                               frames=jnp.asarray(fr), mode=mode, **kw)
    got, _, _ = encdec.apply(params, cfg, torch.from_numpy(toks),
                             frames=torch.from_numpy(fr), mode=mode, **kw)
    _close(got, ref, 5e-2)


def test_apply_takes_enc_out_in_place_of_frames():
    j_cfg, cfg, j_params, params = _reference()
    toks = np.arange(1, 8)[None].repeat(2, 0)
    fr = torch.from_numpy(_x((2, 10, cfg.d_model), 13, 0.1))
    a, _, _ = encdec.apply(params, cfg, torch.from_numpy(toks), frames=fr)
    b, _, _ = encdec.apply(params, cfg, torch.from_numpy(toks),
                           enc_out=encdec.encode(params, cfg, fr))
    assert torch.equal(a, b)
    ref, _, _ = j_encdec.apply(j_params, j_cfg, jnp.asarray(toks, jnp.int32),
                               enc_out=j_encdec.encode(
                                   j_params, j_cfg, jnp.asarray(fr.numpy())))
    _close(b, ref)


def _teacher_forcing(params, cfg, T, cross_len, apply=encdec.apply,
                     j=False):
    """The reference's test_prefill_decode_matches_teacher_forcing: train
    logits over S + 3 tokens against a prefill of S and three decodes.
    Returns the largest |prefill or decode - train| over max|train|."""
    B, S, dec = 2, 24, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + dec))
    fr = (rng.standard_normal((B, T, cfg.d_model)) * 0.1).astype(np.float32)
    if j:
        wrap = lambda a: jnp.asarray(a)  # noqa: E731
        toks, fr = jnp.asarray(toks, jnp.int32), jnp.asarray(fr)
        cache = _j_zeros(cfg, B, S + dec, cross_len)
    else:
        wrap = torch.as_tensor
        toks, fr = torch.from_numpy(toks), torch.from_numpy(fr)
        cache = encdec.cache_init(cfg, B, S + dec, cross_len=cross_len,
                                  device="cpu")
    full, _, _ = apply(params, cfg, toks, frames=fr, mode="train")
    full = np.asarray(full)
    lp, cache, _ = apply(params, cfg, toks[:, :S], frames=fr,
                         mode="prefill", caches=cache)
    worst = np.abs(np.asarray(lp) - full[:, :S]).max()
    for i in range(dec):
        ld, cache, _ = apply(params, cfg, toks[:, S + i:S + i + 1],
                             mode="decode", length=wrap(np.int32(S + i)),
                             caches=cache)
        worst = max(worst, np.abs(np.asarray(ld)[:, 0] - full[:, S + i])
                    .max())
    return worst / np.abs(full).max()


def test_prefill_decode_matches_teacher_forcing():
    """The port's version of the reference's test (16 frames, cross_len
    16), at the port's tolerance."""
    _, cfg, _, params = _reference()
    with torch.no_grad():
        assert _teacher_forcing(params, cfg, CROSS, CROSS) <= 1e-5


def test_reference_cross_decode_attends_to_unwritten_rows():
    """ROADMAP Queue 3: with 8 frames and cross_len 16 the reference's
    decode attends to the 8 zero rows past the frames, so its decode
    logits leave teacher forcing by far; with 16 frames they agree.  The
    port masks each slot to the rows its prefill wrote and agrees with
    teacher forcing either way."""
    j_cfg, cfg, j_params, params = _reference()
    half = _teacher_forcing(j_params, j_cfg, 8, CROSS, j_encdec.apply, True)
    full = _teacher_forcing(j_params, j_cfg, CROSS, CROSS, j_encdec.apply,
                            True)
    assert half > 1e-2 and full < 1e-5
    with torch.no_grad():
        assert _teacher_forcing(params, cfg, 8, CROSS) <= 1e-5
        assert _teacher_forcing(params, cfg, 3, CROSS) <= 1e-5


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    tgt[0, :3] = -1
    return {"frames": _x((2, 12, cfg.d_model), seed, 0.1),
            "inputs": rng.integers(0, cfg.vocab_size, (2, 10)).astype(
                np.int32),
            "targets": tgt}


def _port_loss_and_grads(params, cfg, batch):
    leaves = module.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = encdec.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def test_loss_fn_and_gradients_match_reference():
    """Some targets masked: the loss, its metrics and every parameter's
    gradient (the encoder's through the cross-attention) against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    j_cfg, cfg, j_params, params = _reference()
    batch = _batch(cfg)
    (j_loss, j_m), j_grads = jax.value_and_grad(
        j_encdec.loss_fn, has_aux=True)(
        j_params, j_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m, grads = _port_loss_and_grads(params, cfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    assert int(m["tokens"]) == int(j_m["tokens"]) == 17
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(j_m[k]),
                                   rtol=1e-5,
                                   atol=1e-7)
    ref = jax.tree_util.tree_flatten_with_path(encdec.params_from_reference(
        _np(j_grads), cfg, device="cpu"))[0]
    assert len(ref) == len(grads)
    top = max(float(r.abs().max()) for _, r in ref)
    for g, (path, r) in zip(grads, ref):
        assert g.shape == r.shape
        if jax.tree_util.keystr(path).endswith("['xattn']['wk']['b']"):
            # with no RoPE a key bias shifts every score of a query alike,
            # which no softmax sees: the cross layers' key-bias gradient
            # is 0 up to rounding on both sides
            assert float(g.abs().max()) <= 1e-6 * top
            continue
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_remat_carries_enc_out_bit_equal():
    """remat recomputes each encoder and decoder layer in the backward,
    the decoder's with enc_out: loss and gradients the same bits as
    without."""
    j_cfg, cfg, j_params, _ = _reference()
    batch = _batch(cfg, seed=4)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = encdec.params_from_reference(_np(j_params), c, device="cpu")
        loss, _, grads = _port_loss_and_grads(params, c, batch)
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# --- the Engine --------------------------------------------------------------
def _serve_both(frames, prompts, max_new, seed=0, **skw):
    j_cfg, cfg, _, _ = _reference()
    skw = dict(dict(max_batch=2, max_len=48, prefill_bucket=8,
                    cross_len=CROSS), **skw)
    j_eng = JEngine(j_cfg, JServeConfig(**skw), seed=seed)
    eng = Engine(cfg, ServeConfig(**skw), device="cpu",
                 params=encdec.params_from_reference(_np(j_eng.params), cfg,
                                                     device="cpu"))
    out = []
    for e, req in ((j_eng, JRequest), (eng, Request)):
        reqs = [req(prompt=p, max_new=max_new, frames=f)
                for p, f in zip(prompts, frames)]
        for r in reqs:
            e.submit(r)
        e.run_until_done()
        assert all(r.done and len(r.generated) == max_new for r in reqs)
        out.append([r.generated for r in reqs])
    return j_eng, eng, out


@pytest.mark.parametrize("with_frames", [True, False])
def test_engine_tokens_match_jax_engine(with_frames):
    """Frames that fill cross_len (or none: zeros of cross_len rows, as
    both engines default), prompts of 5-20 tokens over 2 slots."""
    cfg = get_config(ARCH).reduced()
    prompts = [[(7 * i + 3) % 503 + 1 for i in range(n)]
               for n in (5, 17, 20, 9)]
    frames = [_x((CROSS, cfg.d_model), 20 + i, 0.1) if with_frames
              else None for i in range(len(prompts))]
    j_eng, eng, (ref, got) = _serve_both(frames, prompts, 5)
    assert got == ref
    assert eng.tokens_generated == j_eng.tokens_generated
    assert eng.decode_steps == j_eng.decode_steps


def _greedy(params, cfg, prompt, frames, n):
    """n greedy tokens by teacher forcing: ``apply`` in train mode over the
    whole sequence so far, the last position's argmax."""
    toks = list(prompt)
    fr = torch.from_numpy(frames)[None]
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = encdec.apply(params, cfg,
                                        torch.tensor([toks]), frames=fr)
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def test_engine_masks_each_slot_to_its_frames():
    """Requests of 16, 8 and 3 frames (cross_len 16) share the batch: each
    request's tokens equal greedy teacher forcing over its own frames, and
    each slot's ``clen`` holds its frame count while it decodes."""
    cfg = get_config(ARCH).reduced()
    params = encdec.init(5, cfg, device="cpu")
    eng = Engine(cfg, ServeConfig(max_batch=3, max_len=40, prefill_bucket=8,
                                  cross_len=CROSS),
                 params=params, device="cpu")
    rows = (CROSS, 8, 3)
    reqs = [Request(prompt=[(5 * i + j) % 500 + 1 for j in range(6 + i)],
                    max_new=6, frames=_x((T, cfg.d_model), 30 + i, 0.5))
            for i, T in enumerate(rows)]
    for r in reqs:
        eng.submit(r)
    seen = []
    eng.run_until_done(before_decode=lambda e: seen.append(
        e.cache[0]["xattn"]["clen"].tolist()))
    assert seen[0] == list(rows)
    for r in reqs:
        assert r.generated == _greedy(params, cfg, r.prompt, r.frames, 6)


def test_serve_cli_on_the_cpu(capsys):
    """The launcher's request shapes (128 frames of 0.1 * N(0, 1)) on
    reduced whisper-tiny; kernel 5's plain version on the CPU."""
    dec_ops.reset_launch_counts()
    serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "3",
                "--max-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests; 9 tokens" in out and "on cpu" in out
    assert dec_ops.launch_counts() == {"decode_attn": 0}
