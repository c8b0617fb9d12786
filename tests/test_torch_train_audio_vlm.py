"""Training the audio (whisper-tiny) and vision-language
(phi-3-vision-4.2b) families through the port's ``Trainer`` against the
reference's, on the CPU.

Both trainers start from one set of parameters (the port's ``init``,
carried into the reference's layout) and take the same step-keyed
batches, frames or patches included (``data/pipeline.py``, bit-equal to
the reference's).  Tolerances are ``tests/test_torch_trainer.py``'s for
the other families: each step's loss and grad norm within 1e-5 relative,
the parameters after the run within the restart bound (rtol 1e-4, atol
1e-5; f32, summation orders differ).  Checkpoints are in the reference's
layout, so either package restores the other's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.checkpoint.checkpoint import _leaf_name
from repro.configs import get_config as j_get_config
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec, lm, model_for, vlm
from repro_torch.nn.module import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig

ARCHS = ["whisper-tiny", "phi-3-vision-4.2b"]
STEPS = dict(steps=3, batch=2, seq_len=16, log_every=1, warmup=1)


def _jnp(tree):
    return jax.tree_util.tree_map(
        lambda t: jax.numpy.asarray(t.detach().numpy()), tree)


def _both(arch, **kw):
    """The port's and the reference's trainers from one set of params."""
    kw = dict(STEPS, **kw)
    j_cfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    mod = model_for(cfg)
    params = mod.init(0, cfg, device="cpu")
    jt = JTrainer(j_cfg, JTrainerConfig(**kw), params=_jnp(
        mod.to_reference_layout(params, cfg, device="cpu")))
    tr = Trainer(cfg, TrainerConfig(**kw), device="cpu", params=params)
    return tr, jt, cfg


def _named(tree, name=""):
    """(path, tensor) in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{name}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{name}[{i}]")
    else:
        yield name, tree


def _assert_params_close(port_params, j_params, cfg, steps=STEPS["steps"]):
    """Every leaf within the restart bound of the reference's, but the key
    projections' biases: softmax is invariant to them, so their gradient
    is float noise in both packages, and AdamW's normalised step turns
    that noise into moves of up to lr a step in any direction.  Those are
    held to that bound, 2 lr a step apart."""
    ref = model_for(cfg).params_from_reference(
        jax.tree_util.tree_map(np.asarray, j_params), cfg, device="cpu")
    got, want = list(_named(port_params)), list(_named(ref))
    assert [n for n, _ in got] == [n for n, _ in want]
    lr = TrainerConfig().base_lr
    for (name, x), (_, y) in zip(got, want):
        x, y = x.detach().numpy(), y.numpy()
        if name.endswith("attn/wk/b"):
            assert np.abs(x - y).max() <= 2 * lr * steps, name
        else:
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match_reference(arch):
    """Three steps: each step's loss, accuracy and grad norm agree with the
    reference trainer's and the params after them within the restart
    bound."""
    tr, jt, cfg = _both(arch)
    j_hist = jt.run()
    hist = tr.run()
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == \
        [1, 2, 3]
    for h, jh in zip(hist, j_hist):
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(h[k], jh[k], rtol=1e-5)
        np.testing.assert_allclose(h["accuracy"], jh["accuracy"], atol=1e-6)
    _assert_params_close(tr.state["params"], jt.state["params"], cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_carry_frames_or_patches(arch):
    """The trainer's batches hold the reference's frames (min(seq_len,
    128) of d_model) or patches (num_patches of 1,024), equal to its own
    stream's."""
    tr, jt, cfg = _both(arch, seq_len=8)
    got = next(tr._make_data(2))
    want = next(jt._make_data(2))
    key = "frames" if cfg.family == "audio" else "patches"
    shape = ((2, 8, cfg.d_model) if key == "frames"
             else (2, cfg.num_patches, vlm.CLIP_DIM))
    assert tuple(got[key].shape) == shape
    for k in ("inputs", "targets", key):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_uses_the_reference_layout(arch, tmp_path):
    """Leaf names, shapes and dtypes of the port's checkpoint are those of
    the reference's state; the reference resumes from it and lands where
    an unbroken run of the port does."""
    d = str(tmp_path / "ck")
    tr, jt, cfg = _both(arch, steps=2, ckpt_every=2, ckpt_dir=d,
                        log_every=0)
    tr.run()
    flat = jax.tree_util.tree_flatten_with_path(jt.state)[0]
    want = {_leaf_name(p): (list(a.shape), str(a.dtype)) for p, a in flat}
    with open(os.path.join(d, "step_0000000002", "manifest.json")) as f:
        got = {leaf["name"]: (leaf["shape"], leaf["dtype"])
               for leaf in json.load(f)["leaves"]}
    assert got == want
    j_cfg = j_get_config(arch).reduced()
    jt2 = JTrainer(j_cfg, JTrainerConfig(**dict(STEPS, ckpt_dir=d)))
    assert jt2.restore_latest() and int(jt2.state["step"]) == 2
    jt2.run()
    tr3, _, _ = _both(arch)
    tr3.run()
    _assert_params_close(tr3.state["params"], jt2.state["params"], cfg)


def test_failure_recovery_restores_the_audio_state(tmp_path):
    """An injected failure at step 3 restores step 2's checkpoint (the
    encoder and decoder stacks from their reference layout) and replays
    batch 2: the run ends bit-equal to an unbroken one."""
    d = str(tmp_path / "ck")
    fails = {2}
    kw = dict(STEPS, steps=4, ckpt_every=2, ckpt_dir=d, log_every=0)
    cfg = get_config("whisper-tiny").reduced()
    tr = Trainer(cfg, TrainerConfig(**kw), device="cpu",
                 failure_injector=lambda s: s in fails
                 and not fails.discard(s))
    tr.run()
    assert [r["step"] for r in tr.events.recoveries] == [2]
    assert tr.events.recoveries[0]["restored"]
    clean = Trainer(cfg, TrainerConfig(**dict(kw, ckpt_dir="")),
                    device="cpu")
    clean.run()
    for x, y in zip(tree_leaves(tr.state["params"]),
                    tree_leaves(clean.state["params"])):
        assert torch.equal(x, y)


def test_reference_layout_round_trips():
    """encdec's layout holds both stacks as the reference's and comes back
    to the port's layer lists as views of the same values."""
    cfg = get_config("whisper-tiny").reduced()
    p = encdec.init(0, cfg, device="cpu")
    ref = encdec.to_reference_layout(p, cfg, device="cpu")
    assert set(ref["enc_stack"]) == set(ref["dec_stack"]) == {"prefix",
                                                             "scan"}
    back = encdec.from_reference_layout(ref, cfg)
    for x, y in zip(tree_leaves(p), tree_leaves(back)):
        assert torch.equal(x, y)
    assert vlm.to_reference_layout is lm.to_reference_layout


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_on_the_cpu(arch, capsys):
    hist = train_cli.main(["--arch", arch, "--steps", "2", "--batch", "2",
                           "--seq-len", "16", "--device", "cpu"])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "step      2 loss" in capsys.readouterr().out


def test_trainer_refuses_image_models():
    with pytest.raises(ValueError, match="images"):
        Trainer(get_config("alexnet"), TrainerConfig(), device="cpu")
