"""Training runtime: fault tolerance and straggler detection (the
reference's ``repro/runtime/trainer.py``), on one device.

Fault model:
  * step failure (node loss, injected in tests) -> restore the last
    checkpoint and go on; the data stream is keyed by step, so the
    replayed batches are identical;
  * preemption (SIGTERM, caught for the length of ``run``, the previous
    handler put back after) -> a final checkpoint, then a clean exit; a
    restart resumes from it;
  * stragglers -> a z-score of each step's time against the history past
    the two warm-up steps, with a pluggable hook (recorded and logged).

A step is autograd through the family's ``loss_fn`` (``models.lm``'s,
for the mixture-of-experts and hybrid families with the router's
load-balance loss; ``models.encdec``'s on the batch's ``frames`` and
``models.vlm``'s on its ``patches``, as the reference's trainer calls
``model_for(cfg).loss_fn``) and :func:`optim.adamw_step`, which updates
the state in place.  Its time
``dt`` is taken after ``torch.cuda.synchronize()``, as the reference
takes it after ``block_until_ready``.  The state is ``{"step", "params",
"m", "v"}`` as in the reference; its checkpoints are written in the
reference's layout
(the layers stacked under ``params/stack/scan/b<j>``, an encoder-decoder's
under ``enc_stack`` and ``dec_stack``; the same leaf names, shapes and
dtypes), so each package restores the other's.  The mesh and
``reshard_state`` (elastic re-placement) come with ROADMAP Queue 1 item
7d's parallel part.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..config import ArchConfig
from ..core.device import resolve_device
from ..core.streambuf import StreamBuffer
from ..data.pipeline import synthetic_batches
from ..models import encdec, lm, model_for, vlm
from ..nn.module import tree_leaves, tree_map
from ..optim import adamw_step, init_state, lr_schedule


class InjectedFailure(RuntimeError):
    """Raised by a failure injector to simulate a node loss."""


@dataclass
class TrainerConfig:
    steps: int = 100
    base_lr: float = 1e-3
    warmup: int = 20
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    batch: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = checkpointing off
    ckpt_dir: str = ""
    keep: int = 3
    async_ckpt: bool = False
    straggler_zscore: float = 3.0
    straggler_min_history: int = 16
    seed: int = 0


@dataclass
class TrainerEvents:
    stragglers: list = field(default_factory=list)
    recoveries: list = field(default_factory=list)
    preempted: bool = False


class Trainer:
    """Trains ``cfg`` on ``device`` (the card unless told otherwise).
    ``params``: the port's params tree on that device (default: ``init``
    from ``tcfg.seed``); the trainer owns and updates it in place."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, *,
                 mesh=None, rules=None, data_it=None,
                 failure_injector: Optional[Callable[[int], bool]] = None,
                 straggler_hook: Optional[Callable] = None,
                 params=None, device="cuda"):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "Trainer(mesh=, rules=): the port trains on one device; "
                "meshes and sharding rules come with ROADMAP Queue 1, item "
                "7d's parallel part (parallel/, launch/mesh)")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.mod = model_for(cfg)
        if self.mod not in (lm, encdec, vlm):
            raise ValueError(
                f"Trainer trains the token families (the reference's feeds "
                f"every family token batches); family {cfg.family!r} takes "
                "images")
        self.events = TrainerEvents()
        self._failure_injector = failure_injector
        self._straggler_hook = straggler_hook
        self._times: list = []
        self._sigterm = False
        self.history: list = []

        if params is None:
            params = self.mod.init(tcfg.seed, cfg, device=self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.state = init_state(params)

        self._user_data_it = data_it
        self.data = None           # built lazily at run() aligned to `step`

        self._ckpt = None
        if tcfg.ckpt_every and tcfg.ckpt_dir and tcfg.async_ckpt:
            self._ckpt = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir,
                                                    keep=tcfg.keep)

    # -- the step -------------------------------------------------------------
    def train_step(self, batch) -> dict:
        """One optimizer step on ``batch`` (device tensors), in place;
        returns its metrics as tensors."""
        tc, state = self.tcfg, self.state
        lr = lr_schedule(state["step"], base_lr=tc.base_lr,
                         warmup=tc.warmup, total=tc.steps)
        leaves = tree_leaves(state["params"])
        loss, metrics = self.mod.loss_fn(state["params"], self.cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        del loss
        _, om = adamw_step(state, grads, lr=lr,
                           weight_decay=tc.weight_decay,
                           clip_norm=tc.clip_norm)
        return {**{k: v.detach() for k, v in metrics.items()}, **om,
                "lr": lr}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- fault handling -----------------------------------------------------
    def _install_sigterm(self):
        """Flag SIGTERM for the step loop.  Returns a function that puts
        the replaced handler back: the handler holds the trainer, and
        left installed it would keep the trainer and its state alive
        after ``run``."""
        def handler(signum, frame):
            self._sigterm = True
        try:
            previous = signal.signal(signal.SIGTERM, handler)
        except ValueError:      # not in main thread
            return lambda: None
        return lambda: signal.signal(
            signal.SIGTERM, signal.SIG_DFL if previous is None else previous)

    def checkpoint_state(self) -> dict:
        """The state as the reference lays it out, on the host."""
        st = self.state
        return {"step": st["step"].clone(),
                **{k: self.mod.to_reference_layout(st[k], self.cfg,
                                                   device="cpu")
                   for k in ("params", "m", "v")}}

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        if self._ckpt is not None:
            self._ckpt.submit(self.checkpoint_state())
        else:
            ckpt_lib.save(self.tcfg.ckpt_dir, self.checkpoint_state(),
                          keep=self.tcfg.keep)

    def restore_latest(self) -> bool:
        step = ckpt_lib.latest_step(self.tcfg.ckpt_dir) \
            if self.tcfg.ckpt_dir else None
        if step is None:
            return False
        if self._ckpt is not None:
            self._ckpt.wait()
        # the reference layout's structure, with empty host leaves: restore
        # loads each file onto the host
        empty = self.mod.to_reference_layout(
            tree_map(lambda t: torch.empty(0), self.state["params"]), self.cfg,
            device="cpu")
        like = {"step": torch.zeros((), dtype=torch.int32), "params": empty,
                "m": empty, "v": empty}
        got = ckpt_lib.restore(self.tcfg.ckpt_dir, like)
        with torch.no_grad():
            for k in ("params", "m", "v"):
                src = tree_leaves(self.mod.from_reference_layout(got[k],
                                                                 self.cfg))
                dst = tree_leaves(self.state[k])
                for d, s in zip(dst, src, strict=True):
                    if s.shape != d.shape:
                        raise ValueError(f"checkpoint leaf of {k}: shape "
                                         f"{tuple(s.shape)}, the model's "
                                         f"{tuple(d.shape)}")
                    d.copy_(s)
        self.state["step"] = torch.as_tensor(got["step"], dtype=torch.int32)
        return True

    # -- data -----------------------------------------------------------------
    def _make_data(self, start_step: int):
        """Step-keyed stream: restarting at step s replays batch s exactly
        (checkpoint restore and failure recovery stay reproducible)."""
        if self._user_data_it is not None:
            return StreamBuffer(self._user_data_it, device=self.device)
        tc, cfg = self.tcfg, self.cfg

        def gen():
            s = start_step
            while True:
                it = synthetic_batches(
                    batch=tc.batch, seq_len=tc.seq_len, vocab=cfg.vocab_size,
                    seed=tc.seed + s, family=cfg.family, d_model=cfg.d_model,
                    num_patches=cfg.num_patches,
                    frames_len=min(tc.seq_len, 128), steps=1)
                yield next(it)
                s += 1

        return StreamBuffer(gen(), device=self.device)

    # -- straggler detection --------------------------------------------------
    def _check_straggler(self, step: int, dt: float):
        if len(self._times) < 2:       # warmup: skip the first steps
            self._times.append(dt)
            return
        self._times.append(dt)
        hist = self._times[2:][-256:]
        if len(hist) < self.tcfg.straggler_min_history:
            return
        mu = float(np.mean(hist[:-1]))
        sd = float(np.std(hist[:-1])) + 1e-9
        z = (dt - mu) / sd
        if z > self.tcfg.straggler_zscore:
            ev = {"step": step, "dt": dt, "mean": mu, "z": z}
            self.events.stragglers.append(ev)
            if self._straggler_hook:
                self._straggler_hook(ev)

    # -- main loop ------------------------------------------------------------
    def run(self) -> list:
        restore = self._install_sigterm()
        try:
            return self._run()
        finally:
            restore()

    def _run(self) -> list:
        tc = self.tcfg
        step = int(self.state["step"])
        if self.data is None:
            self.data = self._make_data(step)
        while step < tc.steps:
            batch = next(self.data)
            self._sync()
            t0 = time.perf_counter()
            try:
                if self._failure_injector and self._failure_injector(step):
                    raise InjectedFailure(f"injected failure @ step {step}")
                metrics = self.train_step(batch)
                self._sync()
            except InjectedFailure as e:
                restored = self.restore_latest()
                self.events.recoveries.append(
                    {"step": step, "restored": restored, "err": str(e)})
                # re-align the (step-keyed) data stream with the restored step
                step = int(self.state["step"])
                self.data = self._make_data(step)
                continue
            dt = time.perf_counter() - t0
            step = int(self.state["step"])
            self._check_straggler(step, dt)
            if tc.log_every and step % tc.log_every == 0:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, dt=dt)
                self.history.append(rec)
            if tc.ckpt_every and step % tc.ckpt_every == 0:
                self.save()
            if self._sigterm:
                self.events.preempted = True
                self.save()
                break
        if self._ckpt is not None:
            self._ckpt.wait()
        return self.history
