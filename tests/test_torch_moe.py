"""The port's mixture-of-experts layer (``nn/moe.py``) against the JAX
package's ``repro.nn.moe.moe_apply``.

The same numpy-made inputs on both sides and the reference's parameters
carried over, all on the CPU.  Gates: the routed expert indices exactly
equal; y within 1e-5 * max|y| in f32 and 1e-2 * max|y| with bf16
activations (the router is f32 on both sides, so the indices still
match); the router's aux loss within 1e-6.  Configs: the reference's own
``tests/test_moe.py`` one (capacity factor 100 and 0.01, shared experts
on and off) and reduced granite-moe-1b-a400m and deepseek-v2-lite-16b (8
experts, top-2, groups of 16, capacity factor 1.25: tokens are dropped).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.config import ArchConfig as JArchConfig
from repro.config import MoECfg as JMoECfg
from repro.configs import get_config as j_get_config
from repro.nn import layers as j_layers
from repro.nn import moe as j_moe
from repro_torch.config import ArchConfig, MoECfg
from repro_torch.configs import get_config
from repro_torch.nn import moe


def _test_moe_cfg(arch_cls, moe_cls, cf, shared):
    """The reference's ``tests/test_moe.py::_cfg``."""
    m = moe_cls(num_experts=8, top_k=2, d_ff=32, group_size=16,
                capacity_factor=cf, num_shared=shared)
    return arch_cls(name="t", family="moe", num_layers=2, d_model=16,
                    num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
                    vocab_size=64, moe=m, dtype="float32",
                    param_dtype="float32")


# name -> (reference cfg, port cfg)
CFGS = {
    "cf100": lambda: (_test_moe_cfg(JArchConfig, JMoECfg, 100.0, 0),
                      _test_moe_cfg(ArchConfig, MoECfg, 100.0, 0)),
    "cf100_shared": lambda: (_test_moe_cfg(JArchConfig, JMoECfg, 100.0, 2),
                             _test_moe_cfg(ArchConfig, MoECfg, 100.0, 2)),
    "cf0.01": lambda: (_test_moe_cfg(JArchConfig, JMoECfg, 0.01, 0),
                       _test_moe_cfg(ArchConfig, MoECfg, 0.01, 0)),
    "granite": lambda: (j_get_config("granite-moe-1b-a400m").reduced(),
                        get_config("granite-moe-1b-a400m").reduced()),
    "deepseek": lambda: (j_get_config("deepseek-v2-lite-16b").reduced(),
                         get_config("deepseek-v2-lite-16b").reduced()),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _layer(name, seed=0, dtype="float32"):
    j_cfg, cfg = CFGS[name]()
    j_cfg = dataclasses.replace(j_cfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    j_p = _np(j_moe.moe_init(jax.random.PRNGKey(seed), j_cfg))
    return j_cfg, cfg, j_p, _torch(j_p)


def _x(shape, dtype="float32", seed=1):
    """Inputs from a numpy seed; in bf16 rounded once, so both sides read
    identical values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _reference_routing(j_p, j_cfg, x):
    """The reference's group, pad and route (``moe.py:49-63``) -> expert
    indices (G, sg, k)."""
    m = j_cfg.moe
    B, S, D = x.shape
    sg = min(m.group_size, S)
    pad = (-S) % sg
    xp = jnp.pad(x, ((0, 0), (0, pad), (0, 0))) if pad else x
    xg = xp.reshape(-1, sg, D)
    logits = j_layers.linear(j_p["router"], xg, dtype=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    return np.asarray(idx)


def _port_routing(p, cfg, x):
    xg, _ = moe.group(cfg, x)
    return moe.route(p, cfg, xg)[2].numpy()


def _both(name, S, dtype="float32", B=2):
    j_cfg, cfg, j_p, p = _layer(name, dtype=dtype)
    x = _x((B, S, cfg.d_model), dtype)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref, j_aux = j_moe.moe_apply(j_p, j_cfg, jx, return_aux=True)
    got, aux = moe.moe_apply(p, cfg, tx, return_aux=True)
    return (np.asarray(ref.astype(jnp.float32)), float(j_aux),
            got.float().numpy(), float(aux),
            _reference_routing(j_p, j_cfg, jx),
            _port_routing(p, cfg, tx), got.dtype)


@pytest.mark.parametrize("S", [16, 20, 1])
@pytest.mark.parametrize("name", list(CFGS))
def test_moe_matches_reference(name, S):
    """f32: routed indices exact, y within 1e-5 * max|y|, aux 1e-6."""
    ref, j_aux, got, aux, j_idx, idx, dt = _both(name, S)
    assert dt == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert aux == pytest.approx(j_aux, abs=1e-6)


@pytest.mark.parametrize("S", [16, 20, 1])
@pytest.mark.parametrize("name", ["granite", "deepseek", "cf100_shared"])
def test_moe_matches_reference_bf16(name, S):
    """bf16 activations on identical bf16 inputs: the f32 router picks the
    same experts; y within 1e-2 * max|y|."""
    ref, j_aux, got, aux, j_idx, idx, dt = _both(name, S, "bfloat16")
    assert dt == torch.bfloat16
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())
    assert aux == pytest.approx(j_aux, abs=1e-6)


def test_capacity_matches_reference():
    for name in CFGS:
        j_cfg, cfg = CFGS[name]()
        for sg in (1, 7, 16, 128):
            assert moe.moe_capacity(cfg.moe, sg) == \
                j_moe.moe_capacity(j_cfg.moe, sg)
    # reduced granite drops tokens: 5 slots an expert for 32 choices of 16
    assert moe.moe_capacity(get_config("granite-moe-1b-a400m").reduced()
                            .moe, 16) == 5


# --- ties -------------------------------------------------------------------
def _tie_case():
    """S = 20 in groups of 16: the second group holds 4 real tokens and 12
    zero pad rows, whose router probabilities are exactly uniform."""
    j_cfg, cfg, j_p, p = _layer("granite", seed=3)
    x = _x((1, 20, cfg.d_model), seed=4)
    return j_cfg, cfg, j_p, p, x


def test_pad_rows_tie_and_the_port_matches_on_the_real_rows():
    """The pad rows' top-k picks are all ties; taken lower index first (as
    ``jax.lax.top_k``), their top-1 slots come before the real rows'
    top-2 slots, and the port's real rows 16-19 match the reference's."""
    j_cfg, cfg, j_p, p, x = _tie_case()
    xg, pad = moe.group(cfg, torch.from_numpy(x))
    assert pad == 12
    probs, _, idx = moe.route(p, cfg, xg)
    assert bool((probs[1, 4:] == 1.0 / cfg.moe.num_experts).all())
    assert idx[1, 4:].tolist() == [[0, 1]] * 12
    ref, _ = j_moe.moe_apply(j_p, j_cfg, jnp.asarray(x))
    got, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy()[0, 16:], ref[0, 16:], rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(_port_routing(p, cfg, torch.from_numpy(x)),
                                  _reference_routing(j_p, j_cfg,
                                                     jnp.asarray(x)))


def test_torch_topk_tie_order_would_not_match(monkeypatch):
    """``torch.topk`` orders ties otherwise on this CPU: with it in place
    of the stable sort, the pad rows pick other experts and the real rows
    16-19 leave the reference; so the stable sort stays."""
    j_cfg, cfg, j_p, p, x = _tie_case()
    probs = torch.full((12, cfg.moe.num_experts), 1.0 / cfg.moe.num_experts)
    assert torch.topk(probs, 2).indices.tolist() != [[0, 1]] * 12
    monkeypatch.setattr(moe, "top_k",
                        lambda pr, k: tuple(torch.topk(pr, k)))
    ref, _ = j_moe.moe_apply(j_p, j_cfg, jnp.asarray(x))
    got, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    ref = np.asarray(ref)
    worst = np.abs(got.numpy()[0, 16:] - ref[0, 16:]).max()
    assert worst > 1e-2 * np.abs(ref).max()


# --- the reference's own facts, on the port ---------------------------------
def test_shared_experts_are_always_on():
    _, cfg, _, p = _layer("cf100_shared")
    assert "shared" in p
    x = torch.from_numpy(_x((1, 16, 16)))
    p2 = dict(p, router={"w": torch.zeros_like(p["router"]["w"])})
    y2, _ = moe.moe_apply(p2, cfg, x)
    assert float(y2.abs().mean()) > 0


def test_aux_loss_prefers_balance():
    _, cfg, _, p = _layer("cf100")
    x = torch.from_numpy(_x((2, 16, 16)))
    _, aux = moe.moe_apply(p, cfg, x, return_aux=True)
    w = p["router"]["w"].clone()
    w[:, 0] = 100.0
    _, aux_bad = moe.moe_apply(dict(p, router={"w": w}), cfg, x,
                               return_aux=True)
    assert float(aux_bad) > float(aux) > 0
    assert moe.moe_apply(p, cfg, x)[1] is None


def test_init_matches_reference_structure():
    """``moe_init`` draws the reference's tree, shapes and dtypes."""
    for name in ("granite", "deepseek", "cf100_shared"):
        j_cfg, cfg, j_p, _ = _layer(name)
        mine = moe.moe_init(torch.Generator().manual_seed(0), cfg)
        flat = jax.tree_util.tree_flatten_with_path
        assert [(k, tuple(v.shape)) for k, v in flat(mine)[0]] == \
            [(k, tuple(v.shape)) for k, v in flat(j_p)[0]]
        assert all(v.dtype == torch.float32 for _, v in flat(mine)[0])
