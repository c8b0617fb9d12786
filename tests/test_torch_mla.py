"""The port's multi-head latent attention (DeepSeek-V2's MLA, in
``nn/attention.py``) against the JAX package's
``repro.nn.attention.mla_apply``.

Reduced deepseek-v2-lite-16b (kv_lora 32, nope 16, rope 8, v 16, 4
heads), the reference's parameters carried over, numpy-made inputs, all
on the CPU and in f32.  Gates: outputs within 1e-5 * max|y| in train,
prefill and decode mode (decode at ragged per-slot lengths from the
reference's prefilled cache); the ``ckv`` / ``kpe`` caches within 1e-5;
the absorbed decode within 1e-5 * max of the materialised one (per-head
K and V at cache length, ``attention.mla_decode_materialised``, which
``chip_smoke.py`` holds the card's absorbed route against).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.nn import attention as j_attn
from repro_torch.configs import get_config
from repro_torch.nn import attention

ARCH = "deepseek-v2-lite-16b"
L = 24


def _layer(seed=0):
    j_cfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    j_p = jax.tree_util.tree_map(
        np.asarray, j_attn.attn_init(jax.random.PRNGKey(seed), j_cfg))
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), j_p)
    return j_cfg, cfg, j_p, p


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _zeros(cfg):
    return {n: torch.zeros(shape, dtype=dt)
            for n, (shape, dt) in attention.attn_cache_shape(cfg, 2, L)
            .items()}


def _prefilled(seed=1):
    """Both sides prefilled with 11 tokens a slot from zero caches."""
    j_cfg, cfg, j_p, p = _layer()
    x = _x((2, 11, cfg.d_model), seed)
    j_cache = j_attn.attn_cache_init(j_cfg, 2, L)
    ref, j_cache = j_attn.mla_apply(j_p, j_cfg, jnp.asarray(x),
                                    mode="prefill", cache=j_cache)
    got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x),
                                     mode="prefill", cache=_zeros(cfg))
    return j_cfg, cfg, j_p, p, ref, got, j_cache, cache


def _decode_both(lens=(11, 6), seed=2):
    """One new token a slot at ``lens`` from the reference's prefilled
    cache, on both sides."""
    j_cfg, cfg, j_p, p, _, _, j_cache, _ = _prefilled()
    cache = {n: torch.from_numpy(np.array(a)) for n, a in j_cache.items()}
    x = _x((2, 1, cfg.d_model), seed)
    lens = np.array(lens, np.int32)
    ref, j_cache = j_attn.mla_apply(j_p, j_cfg, jnp.asarray(x),
                                    mode="decode", length=jnp.asarray(lens),
                                    cache=j_cache)
    got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x),
                                     mode="decode",
                                     length=torch.from_numpy(lens),
                                     cache=cache)
    return cfg, p, x, lens, ref, got, j_cache, cache


def test_cache_shape_and_init_match_reference():
    j_cfg, cfg, j_p, p = _layer()
    mine = attention.attn_init(torch.Generator().manual_seed(0), cfg)
    flat = jax.tree_util.tree_flatten_with_path
    assert [(k, tuple(v.shape)) for k, v in flat(mine)[0]] == \
        [(k, tuple(v.shape)) for k, v in flat(j_p)[0]]
    want = j_attn.attn_cache_shape(j_cfg, 3, L)
    got = attention.attn_cache_shape(cfg, 3, L)
    assert set(got) == set(want) == {"ckv", "kpe"}
    for name, (shape, dt) in got.items():
        assert shape == want[name].shape and dt == torch.float32


def test_train_matches_reference():
    j_cfg, cfg, j_p, p = _layer()
    x = _x((2, 11, cfg.d_model), 3)
    ref, _ = j_attn.mla_apply(j_p, j_cfg, jnp.asarray(x), mode="train")
    got, _ = attention.mla_apply(p, cfg, torch.from_numpy(x), mode="train")
    assert got.shape == ref.shape
    _close(got, ref)


def test_prefill_matches_reference_and_fills_the_caches():
    """Outputs, and the normalised ckv and roped kpe written at 0..S-1."""
    _, _, _, _, ref, got, j_cache, cache = _prefilled()
    _close(got, ref)
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=1e-5,
                                   atol=1e-5)
    assert not cache["ckv"][:, 11:].any()


@pytest.mark.parametrize("lens", [(11, 6), (0, 23)])
def test_absorbed_decode_matches_reference(lens):
    """Ragged per-slot lengths (the engine's case), and the edges of the
    cache; the caches after the step by their own names."""
    _, _, _, _, ref, got, j_cache, cache = _decode_both(lens)
    _close(got, ref)
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=1e-5,
                                   atol=1e-5)


def test_absorbed_decode_equals_materialised(monkeypatch):
    """The absorbed route against per-head K/V at cache length, through
    the whole layer, on the same prefilled cache."""
    cfg, p, x, lens, _, got, _, _ = _decode_both()
    j_cache = _prefilled()[6]
    cache = {n: torch.from_numpy(np.array(a)) for n, a in j_cache.items()}
    monkeypatch.setattr(attention, "mla_decode",
                        attention.mla_decode_materialised)
    mat, _ = attention.mla_apply(p, cfg, torch.from_numpy(x), mode="decode",
                                 length=torch.from_numpy(lens), cache=cache)
    _close(got, mat.numpy())


def test_absorbed_decode_equals_materialised_on_random_latents():
    """Both decode functions directly, on random q and caches, S = 1 and
    a shared scalar length."""
    _, cfg, _, p = _layer(seed=5)
    m, H = cfg.mla, cfg.num_heads
    rng = np.random.default_rng(6)
    shapes = ((3, 1, H, m.qk_nope_head_dim), (3, 1, H, m.qk_rope_head_dim),
              (3, L, m.kv_lora_rank), (3, L, m.qk_rope_head_dim))
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in shapes]
    for length in (torch.tensor([4, 0, 17]), torch.tensor(9)):
        a = attention.mla_decode(p, cfg, *t, length)
        b = attention.mla_decode_materialised(p, cfg, *t, length)
        assert a.shape == (3, 1, H, m.v_head_dim)
        _close(a, b.numpy())


def test_attn_apply_dispatches_mla_and_refuses_bidir():
    j_cfg, cfg, j_p, p = _layer()
    x = torch.from_numpy(_x((1, 5, cfg.d_model), 7))
    a, _ = attention.attn_apply(p, cfg, x, mode="train")
    b, _ = attention.mla_apply(p, cfg, x, mode="train")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="MLA encoder"):
        attention.attn_apply(p, cfg, x, mode="bidir")
    # a cross layer has GQA weights under an MLA config, as in the
    # reference's attn_init(cross=True)
    cross = attention.attn_init(torch.Generator().manual_seed(0), cfg,
                                cross=True)
    j_cross = j_attn.attn_init(jax.random.PRNGKey(0), j_cfg, cross=True)
    assert sorted(cross) == sorted(j_cross) == ["wk", "wo", "wq", "wv"]
    for name in cross:
        assert tuple(cross[name]["w"].shape) == j_cross[name]["w"].shape
