"""The port's training runtime on the CPU: the twins of the reference's
trainer tests (``tests/test_runtime.py``), restart across the two packages
in both directions, the training CLI and the 100M example's config.

A cross-package restart holds the port to the reference's own restart
bound, rtol 1e-4 / atol 1e-5: the second half runs in the other package
from the same checkpointed state (f32, summation orders differ)."""
import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch
from _torch_ranks import one_rank_group  # noqa: F401  (fixture)
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.nn.module import tree_leaves
from repro_torch.runtime import InjectedFailure, Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny():
    return get_config("smollm-360m").reduced()


def _trainer(tcfg, **kw):
    return Trainer(_tiny(), tcfg, device="cpu", **kw)


def test_loss_decreases():
    tr = _trainer(TrainerConfig(steps=40, batch=8, seq_len=64, base_lr=3e-3,
                                log_every=5))
    hist = tr.run()
    assert [h["step"] for h in hist] == list(range(5, 45, 5))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_checkpoint_restart_exact(tmp_path, async_ckpt):
    d = str(tmp_path / "ck")
    t1 = _trainer(TrainerConfig(steps=20, batch=4, seq_len=32, ckpt_every=20,
                                ckpt_dir=d, log_every=5,
                                async_ckpt=async_ckpt))
    t1.run()
    t2 = _trainer(TrainerConfig(steps=30, batch=4, seq_len=32, ckpt_dir=d,
                                log_every=5))
    assert t2.restore_latest()
    assert int(t2.state["step"]) == 20
    t2.run()
    t3 = _trainer(TrainerConfig(steps=30, batch=4, seq_len=32, log_every=5))
    t3.run()
    for x, y in zip(tree_leaves(t2.state["params"]),
                    tree_leaves(t3.state["params"])):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_failure_recovery(tmp_path):
    d = str(tmp_path / "ck")
    fails = {15}
    tr = _trainer(TrainerConfig(steps=25, batch=4, seq_len=32, ckpt_every=10,
                                ckpt_dir=d, log_every=5),
                  failure_injector=lambda s: s in fails and
                  not fails.discard(s))
    tr.run()
    assert len(tr.events.recoveries) == 1
    assert tr.events.recoveries[0]["restored"]
    assert tr.events.recoveries[0]["step"] == 15
    assert int(tr.state["step"]) == 25


def test_failure_recovery_replays_the_uninterrupted_run(tmp_path):
    """Recovery restores step 10 and replays batches 10-14 exactly: the
    result is the uninterrupted run's (the data stream is step-keyed)."""
    d = str(tmp_path / "ck")
    fails = {15}
    tcfg = TrainerConfig(steps=20, batch=2, seq_len=16, ckpt_every=10,
                         ckpt_dir=d, log_every=0)
    tr = _trainer(tcfg, failure_injector=lambda s: s in fails and
                  not fails.discard(s))
    tr.run()
    ref = _trainer(dataclasses.replace(tcfg, ckpt_every=0, ckpt_dir=""))
    ref.run()
    for x, y in zip(tree_leaves(tr.state["params"]),
                    tree_leaves(ref.state["params"])):
        assert torch.equal(x, y)


def test_failure_without_checkpoint_retries_the_step():
    fails = {3}
    tr = _trainer(TrainerConfig(steps=5, batch=2, seq_len=8, log_every=0),
                  failure_injector=lambda s: s in fails and
                  not fails.discard(s))
    tr.run()
    assert tr.events.recoveries == [{"step": 3, "restored": False,
                                     "err": "injected failure @ step 3"}]
    assert int(tr.state["step"]) == 5
    assert issubclass(InjectedFailure, RuntimeError)


def test_straggler_detection():
    slow = {30}

    def injector(s):
        if s in slow:
            slow.discard(s)
            time.sleep(1.0)
        return False

    seen = []
    tr = _trainer(TrainerConfig(steps=35, batch=2, seq_len=16, log_every=50,
                                straggler_min_history=8),
                  failure_injector=injector, straggler_hook=seen.append)
    tr.run()
    assert len(tr.events.stragglers) >= 1
    # the slow step (index 30) ends at step 31; CPU noise may add others
    assert 31 in [ev["step"] for ev in tr.events.stragglers]
    assert seen == tr.events.stragglers


def test_run_puts_the_sigterm_handler_back():
    """After ``run`` the process's SIGTERM handler is the one it had, and
    nothing holds the finished trainer: its state is freed with it."""
    import gc
    import signal
    import weakref
    before = signal.getsignal(signal.SIGTERM)
    tr = _trainer(TrainerConfig(steps=2, batch=2, seq_len=8, log_every=0))
    tr.run()
    assert signal.getsignal(signal.SIGTERM) is before
    gone = weakref.ref(tr)
    del tr
    gc.collect()
    assert gone() is None


def test_reference_trainer_keeps_its_sigterm_handler():
    """The fault the port does not copy: the reference's ``run`` leaves
    its SIGTERM handler installed, and the handler's closure holds the
    trainer, so a finished trainer's state lives on until another
    trainer replaces it."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    try:
        jt = JTrainer(j_get_config("smollm-360m").reduced(),
                      JTrainerConfig(steps=1, batch=2, seq_len=8,
                                     log_every=0))
        jt.run()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before
        assert jt in [c.cell_contents for c in handler.__closure__]
    finally:
        signal.signal(signal.SIGTERM, before)


def test_mesh_and_cuda_refusals(monkeypatch, one_rank_group):
    """``Trainer(mesh=)`` (once refused) on a one-rank ("data", "model")
    mesh: the state rests as DTensors, and three steps equal the meshless
    trainer's to the bit (a one-rank all-reduce and a unit share of the
    loss change nothing); ``rules`` need a mesh, a CPU mesh a CPU trainer.
    Without a card, no trainer."""
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         make_production_mesh)
    from repro_torch.parallel import sharding as sh
    mesh = make_mesh((1, 1), ("data", "model"))
    # the named meshes need a world of their size
    with pytest.raises(ValueError, match="world of 4 ranks; it is 1"):
        make_host_mesh()
    with pytest.raises(ValueError, match="world of 256"):
        make_production_mesh()
    tc = TrainerConfig(steps=3, batch=2, seq_len=16, log_every=1)
    params = lm.init(0, _tiny(), device="cpu")
    plain = _trainer(tc, params=lm.to_device(params, "cpu"))
    meshed = _trainer(tc, mesh=mesh, rules={"mlp": None},
                      params=lm.to_device(params, "cpu"))
    assert all(sh.is_dtensor(t) for k in ("params", "m", "v")
               for t in tree_leaves(meshed.state[k]))
    h_plain, h_mesh = plain.run(), meshed.run()
    assert [h["loss"] for h in h_mesh] == [h["loss"] for h in h_plain]
    for a, b in zip(tree_leaves(meshed.state["params"]),
                    tree_leaves(plain.state["params"])):
        assert torch.equal(a.full_tensor(), b.detach())
    with pytest.raises(ValueError, match="needs a mesh"):
        _trainer(tc, rules={"mlp": None})
    with pytest.raises(ValueError, match="cpu mesh"):
        Trainer(_tiny(), tc, mesh=mesh, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(_tiny(), TrainerConfig())


def test_checkpoint_uses_the_reference_layout(tmp_path):
    """Leaf names, shapes and dtypes of the port's training checkpoint are
    those of the reference's state."""
    d = str(tmp_path / "ck")
    tr = _trainer(TrainerConfig(steps=2, batch=2, seq_len=8, ckpt_every=2,
                                ckpt_dir=d, log_every=0))
    tr.run()
    j_cfg = j_get_config("smollm-360m").reduced()
    jt = JTrainer(j_cfg, JTrainerConfig(steps=0, batch=2, seq_len=8))
    flat = jax.tree_util.tree_flatten_with_path(jt.state)[0]
    from repro.checkpoint.checkpoint import _leaf_name
    want = {_leaf_name(p): (list(a.shape), str(a.dtype)) for p, a in flat}
    import json
    with open(os.path.join(d, "step_0000000002", "manifest.json")) as f:
        got = {leaf["name"]: (leaf["shape"], leaf["dtype"])
               for leaf in json.load(f)["leaves"]}
    assert got == want


# --- restart across the packages ---
def _j_params_np(jt):
    return jax.tree_util.tree_map(np.asarray, jt.state["params"])


def _assert_close_to_reference(port_params, j_state_params, cfg):
    """Every leaf within the restart bound of the reference's."""
    ref = lm.params_from_reference(
        jax.tree_util.tree_map(np.asarray, j_state_params), cfg,
        device="cpu")
    for x, y in zip(tree_leaves(port_params), tree_leaves(ref)):
        np.testing.assert_allclose(x.detach().numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _configs(d):
    kw = dict(batch=4, seq_len=32, log_every=5)
    return (dict(kw, steps=10, ckpt_every=10, ckpt_dir=d),
            dict(kw, steps=20, ckpt_dir=d), dict(kw, steps=20))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference trains 10 steps and checkpoints; the port restores
    and trains 10 more; the reference's uninterrupted 20 steps agree."""
    d = str(tmp_path / "ck")
    first, second, whole = _configs(d)
    j_cfg, cfg = j_get_config("smollm-360m").reduced(), _tiny()
    JTrainer(j_cfg, JTrainerConfig(**first)).run()
    tr = Trainer(cfg, TrainerConfig(**second), device="cpu")
    assert tr.restore_latest() and int(tr.state["step"]) == 10
    tr.run()
    jt = JTrainer(j_cfg, JTrainerConfig(**whole))
    jt.run()
    _assert_close_to_reference(tr.state["params"], jt.state["params"], cfg)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port trains 10 steps from the reference's init and checkpoints;
    the reference restores and trains 10 more; its uninterrupted 20 steps
    agree."""
    d = str(tmp_path / "ck")
    first, second, whole = _configs(d)
    j_cfg, cfg = j_get_config("smollm-360m").reduced(), _tiny()
    j_init = JTrainer(j_cfg, JTrainerConfig(**whole))
    tr = Trainer(cfg, TrainerConfig(**first), device="cpu",
                 params=lm.params_from_reference(_j_params_np(j_init), cfg,
                                                 device="cpu"))
    tr.run()
    assert ckpt.latest_step(d) == 10
    jt2 = JTrainer(j_cfg, JTrainerConfig(**second))
    assert jt2.restore_latest()
    assert int(jax.device_get(jt2.state["step"])) == 10
    jt2.run()
    j_init.run()
    _assert_close_to_reference(
        lm.params_from_reference(_j_params_np(jt2), cfg, device="cpu"),
        j_init.state["params"], cfg)


# --- the CLI and the example ---
def test_train_cli_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    hist = train_cli.main(["--arch", "mamba2-2.7b", "--steps", "4",
                           "--batch", "2", "--seq-len", "16", "--device",
                           "cpu", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert ckpt.latest_step(d) == 4
    train_cli.main(["--arch", "mamba2-2.7b", "--steps", "6", "--batch", "2",
                    "--seq-len", "16", "--device", "cpu", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step      6 loss" in out


@pytest.mark.parametrize("argv,match", [
    # --mesh, once refused naming item 7d, needs torchrun's ranks
    # (tests/test_torch_mesh_train.py runs it under torchrun)
    pytest.param(["--mesh", "2x2"], "torchrun", id="argv0-item 7d"),
    # the mixture-of-experts family, once refused naming item 7c, trains
    pytest.param(["--arch", "granite-moe-1b-a400m"], None,
                 id="argv1-item 7c"),
    pytest.param(["--arch", "deepseek-v2-lite-16b"], None,
                 id="argv2-item 7c"),
    # the audio and vlm families, once refused naming item 7d, train on
    # their frames and patches
    pytest.param(["--arch", "whisper-tiny"], None, id="argv3-item 7d"),
    pytest.param(["--arch", "phi-3-vision-4.2b"], None,
                 id="argv4-item 7d")])
def test_train_cli_refusals(argv, match):
    """``--mesh`` outside torchrun is refused with what to do; the MoE
    configs the CLI refused until item 7c train (their router loss in
    every step), and the audio and vlm configs it refused until item 7d's
    one-card rest train too."""
    argv = argv + ["--device", "cpu", "--steps", "2", "--batch", "2",
                   "--seq-len", "16"]
    if match is None:
        hist = train_cli.main(argv)
        assert [h["step"] for h in hist] == [1, 2]
        moe = get_config(argv[1]).moe is not None
        assert all(np.isfinite(h["loss"]) and (h["aux_loss"] > 0) == moe
                   for h in hist)
        return
    with pytest.raises(RuntimeError, match=match):
        train_cli.main(argv)


# --- the mixture-of-experts and hybrid families ---
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b",
             "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_hybrid_trainer_steps_match_reference(arch):
    """Both trainers take 3 steps from one set of params on the same
    step-keyed batches: each step's loss, router loss and grad norm agree
    (1e-5 relative) and the params after them within the file's restart
    bound (rtol 1e-4, atol 1e-5).  Reduced granite (MoE every layer),
    deepseek (a dense prefix layer, MLA) and jamba (the hybrid)."""
    j_cfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(steps=3, batch=2, seq_len=16, log_every=1, warmup=1)
    params = lm.init(0, cfg, device="cpu")
    j_params = jax.tree_util.tree_map(
        lambda t: jax.numpy.asarray(t.detach().numpy()),
        lm.to_reference_layout(params, cfg, device="cpu"))
    jt = JTrainer(j_cfg, JTrainerConfig(**kw), params=j_params)
    j_hist = jt.run()
    tr = Trainer(cfg, TrainerConfig(**kw), device="cpu", params=params)
    hist = tr.run()
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == \
        [1, 2, 3]
    for h, jh in zip(hist, j_hist):
        assert h["aux_loss"] > 0
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(h[k], jh[k], rtol=1e-5)
    _assert_close_to_reference(tr.state["params"], jt.state["params"], cfg)


def test_train_100m_example_config_matches_reference():
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    got = dataclasses.asdict(load("train_100m_torch").make_100m())
    ref = dataclasses.asdict(load("train_100m").make_100m())
    assert got == ref
