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
dtypes), so each package restores the other's.

With a ``mesh`` (a DeviceMesh, ``launch/mesh.py``; every rank of it runs a
Trainer) the state rests sharded: the params are DTensors placed by
``parallel.sharding.param_shardings`` under ``rules``, the moments placed
like them (as the reference's ``init_state`` leaves them).  A step is
computed data-parallel: each rank gathers every parameter whole, runs the
forward and backward above on its share of the global batch (the batch
rule's axes, ("pod", "data"): ranks of one ``model`` group take the same
rows), all-reduces the gradients over those axes, clips by the norm of the
full averaged gradient and updates its own blocks of params, m and v in
place.  The loss is each rank's share of the global masked mean (its sum
over the global count of valid targets), and the metrics are reduced as
sums and counts, so ``history`` is a one-device run's; the MoE router's
load-balance means span the global batch (``sharding.batch_mean``).
Where the mesh's ``model`` axis has more than one rank the step is
tensor-parallel (:func:`mesh_grads`): no parameter is gathered whole, each
rank computes its block of every layer (the reference's GSPMD layout) and
holds its block of the gradient.  Under ``--fsdp`` placements
(``launch/specs.py::state_shardings``, the parameters split over "data"
too) no parameter's block is gathered before the forward: each layer
gathers its own leaves over "data" just before use and the backward
reduce-scatters their gradients to the rank's blocks, which AdamW
updates (``sharding.layer_params``).
:func:`reshard_state` moves a state onto another mesh of the same world,
the reference's elastic scaling; checkpoints gather the state and rank 0
writes it, in the reference's layout as above.
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
from ..parallel import sharding as shlib
from ..parallel.collectives import all_reduce_coalesced, mesh_barrier


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
    """Trains ``cfg`` on ``device`` (the card unless told otherwise), or
    on ``mesh``'s device under sharding ``rules`` (overrides of
    ``sharding.DEFAULT_RULES``).  ``params``: the port's params tree
    (default: ``init`` from ``tcfg.seed``; under a mesh every rank's
    alike); the trainer owns and updates it in place."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, *,
                 mesh=None, rules=None, data_it=None,
                 failure_injector: Optional[Callable[[int], bool]] = None,
                 straggler_hook: Optional[Callable] = None,
                 params=None, device="cuda"):
        if mesh is None and rules is not None:
            raise ValueError("Trainer(rules=) needs a mesh")
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.get_coordinate() is None:
                raise ValueError("Trainer(mesh=): this rank is not in the "
                                 "mesh")
            if self.device.type != mesh.device_type:
                raise ValueError(f"Trainer(mesh=): a {mesh.device_type} "
                                 f"mesh, device {device!r}")
            self.device = torch.device(mesh.device_type)
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
        if mesh is None:
            for p in tree_leaves(params):
                p.requires_grad_(True)
        else:
            params = _place_params(params, mesh, rules, self.device)
        self.state = init_state(params)

        self._user_data_it = data_it
        self.data = None           # built lazily at run() aligned to `step`

        # under a mesh rank 0 writes the checkpoints
        self._writer = mesh is None or not any(mesh.get_coordinate())
        self._ckpt = None
        if (tcfg.ckpt_every and tcfg.ckpt_dir and tcfg.async_ckpt
                and self._writer):
            self._ckpt = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir,
                                                    keep=tcfg.keep)

    # -- the step -------------------------------------------------------------
    def train_step(self, batch) -> dict:
        """One optimizer step on ``batch`` (device tensors; under a mesh
        the global batch, alike on every rank), in place; returns its
        metrics as tensors (:func:`train_step`)."""
        tc = self.tcfg
        return train_step(self.mod, self.cfg, self.state, batch,
                          base_lr=tc.base_lr, warmup=tc.warmup,
                          total=tc.steps, weight_decay=tc.weight_decay,
                          clip_norm=tc.clip_norm, mesh=self.mesh,
                          rules=self.rules)

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
        """The state as the reference lays it out, on the host (under a
        mesh gathered whole: every rank of it takes part)."""
        st = self.state
        return {"step": st["step"].clone(),
                **{k: self.mod.to_reference_layout(
                    tree_map(shlib.full, st[k]), self.cfg, device="cpu")
                   for k in ("params", "m", "v")}}

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        state = self.checkpoint_state()
        if not self._writer:
            return
        if self._ckpt is not None:
            self._ckpt.submit(state)
        else:
            ckpt_lib.save(self.tcfg.ckpt_dir, state, keep=self.tcfg.keep)

    def restore_latest(self) -> bool:
        if self._ckpt is not None:
            self._ckpt.wait()
        if self.mesh is not None:
            # rank 0's writes are on disk before any rank reads
            mesh_barrier(self.mesh)
        step = ckpt_lib.latest_step(self.tcfg.ckpt_dir) \
            if self.tcfg.ckpt_dir else None
        if step is None:
            return False
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
                    shlib.local(d).copy_(shlib.shard_of(s, d))
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


def train_step(mod, cfg: ArchConfig, state, batch, *, base_lr: float,
               warmup: int, total: int, weight_decay: float,
               clip_norm: float, mesh=None, rules=None) -> dict:
    """One optimizer step of ``state`` on ``batch`` in place, the
    ``Trainer``'s and the dry run's (``launch/specs.py``): autograd through
    ``mod.loss_fn`` (meshless) or :func:`mesh_grads`, then
    :func:`optim.adamw_step` at ``lr_schedule(state["step"])``.  Returns
    the metrics as tensors."""
    lr = lr_schedule(state["step"], base_lr=base_lr, warmup=warmup,
                     total=total)
    if mesh is None:
        leaves = tree_leaves(state["params"])
        loss, metrics = mod.loss_fn(state["params"], cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        del loss
        metrics = {k: v.detach() for k, v in metrics.items()}
    else:
        grads, metrics = mesh_grads(mod, cfg, state["params"], batch, mesh,
                                    rules)
    _, om = adamw_step(state, grads, lr=lr, weight_decay=weight_decay,
                       clip_norm=clip_norm)
    return {**metrics, **om, "lr": lr}


def mesh_grads(mod, cfg: ArchConfig, params, batch, mesh, rules=None):
    """(the gradient averaged over the global batch, its metrics) from
    this rank's share of ``batch`` and the reductions over the batch
    axes.  On a mesh whose ``model`` axis has one rank: every parameter
    gathered whole, the forward and backward on the share, the gradients
    all-reduced in buckets.  With more (tensor-parallel compute): each
    parameter's ``model`` block, the layers computing the rank's block
    (``sharding.model_share``), each rank's objective a 1 / model share of
    the loss, a model-split leaf's gradient the rank's block, and a
    replicated leaf's the sum of the ``model`` ranks' shares (each
    counted once), before the all-reduce over the batch axes.  A leaf the
    state splits over a batch axis too (``--fsdp``:
    ``sharding.gathered_axes``) goes in as its own block, gathered by
    each layer at its use (``sharding.layer_params``); its gradient comes
    back as that block, already summed over the axes it was gathered
    over, and is all-reduced over the other batch axes only."""
    with shlib.use_mesh_rules(mesh, rules):
        index, count = shlib.batch_share(mesh)
        batch_axes = shlib._batch_axes(mesh)
        groups = shlib.batch_groups(mesh)
        share = shlib.model_share(mesh)
        gathered = [shlib.gathered_axes(p) for p in tree_leaves(params)]
    rows = batch["inputs"].shape[0]
    if rows % count:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{count} data-parallel ranks")
    rows //= count
    mine = {k: v[index * rows:(index + 1) * rows] for k, v in batch.items()}
    for axes in gathered:
        if set(axes) - set(batch_axes):
            raise ValueError(f"a parameter split over {axes}: the step "
                             f"gathers parameters over the batch axes "
                             f"{batch_axes} only")

    def take(p):
        if shlib.gathered_axes(p):
            # handed to the layers with its placement: they gather it
            return shlib.Placed(shlib.local(p).detach().requires_grad_(), p)
        t = shlib.full(p) if share is None else shlib.model_block(p)
        return t.detach().requires_grad_()

    with torch.no_grad():
        whole = tree_map(take, params)
    leaves = [t.block if isinstance(t, shlib.Placed) else t
              for t in tree_leaves(whole)]
    with shlib.use_mesh_rules(mesh, rules):
        _, metrics = mod.loss_fn(whole, cfg, mine)
        # this rank's share of the global masked mean: its sum of the
        # per-token losses (loss x its count) over the global count
        own = metrics["tokens"].to(torch.float32)
        sums = torch.stack([metrics["loss"].detach() * own,
                            metrics["accuracy"].detach() * own,
                            (mine["targets"] >= 0).sum().to(torch.float32)])
        all_reduce_coalesced([sums], groups)
        tokens = torch.clamp(sums[2], min=1)
        # the router loss is the global batch's on every rank already
        objective = metrics["loss"] * (own / tokens) \
            + metrics["aux_loss"] / count
        if share is not None:
            objective = objective / share.size
        # under a model share a leaf may take no part on a rank (a bias
        # its rank-0 partial sum holds): its share is zero.  The backward
        # runs under the rules too: a remat recompute runs the layers.
        grads = torch.autograd.grad(objective, leaves,
                                    materialize_grads=share is not None
                                    or any(gathered))
    del objective, whole, leaves
    if share is not None and share.size > 1:
        split = [shlib.model_sharded(p) for p in tree_leaves(params)]
        all_reduce_coalesced([g for g, s in zip(grads, split) if not s],
                             [share.group])
    # each leaf over the batch axes it was not gathered over: one bucketed
    # pass a set of axes, in the order the sets first appear
    for axes in dict.fromkeys(gathered):
        rest = [mesh.get_group(a) for a in batch_axes if a not in axes]
        all_reduce_coalesced([g for g, a in zip(grads, gathered)
                              if a == axes], rest)
    return grads, {"loss": sums[0] / tokens, "accuracy": sums[1] / tokens,
                   "tokens": tokens,
                   "aux_loss": metrics["aux_loss"].detach()}


def _place_params(params, mesh, rules, device):
    """``params`` on ``device`` as DTensors placed by the rules'
    ``param_shardings`` on ``mesh``."""
    params = tree_map(lambda t: t.detach().to(device), params)
    with shlib.use_mesh_rules(mesh, rules):
        return shlib.place_tree(params, shlib.param_shardings(params, mesh))


def reshard_state(state, mesh, rules=None):
    """Elastic re-placement of a state onto ``mesh``, another mesh of the
    same world, grown or shrunk: each leaf gathered whole on its old mesh,
    then placed by the new mesh's ``param_shardings`` (the moments like the
    params); ``step`` stays a host scalar.  Every rank of the world calls
    it, with its state or None where it holds none; a rank of the new mesh
    without a state gets rank 0's.  Returns the new state, or None on a
    rank outside ``mesh``."""
    import torch.distributed as dist
    held = [None] * dist.get_world_size()
    dist.all_gather_object(held, state is not None
                           or mesh.get_coordinate() is None)
    whole = None
    if state is not None:
        with torch.no_grad():
            whole = {"step": state["step"].clone(),
                     **{k: tree_map(lambda t: shlib.full(t).detach(),
                                    state[k]) for k in ("params", "m", "v")}}
    if not all(held):
        whole = _broadcast_state(whole, torch.device(mesh.device_type))
    if mesh.get_coordinate() is None:
        return None
    params = whole.pop("params")
    return {"step": whole["step"],
            "params": _place_params(params, mesh, rules, mesh.device_type),
            **{k: _place_params(whole[k], mesh, rules, mesh.device_type)
               for k in ("m", "v")}}


def _broadcast_state(whole, device):
    """Rank 0's gathered state on every rank of the world: its structure
    as an object (a (shape, dtype) tuple a leaf), then each leaf."""
    import torch.distributed as dist
    skeleton = [None if whole is None else
                {"step": int(whole["step"]),
                 **{k: tree_map(lambda t: (tuple(t.shape), t.dtype),
                                whole[k]) for k in ("params", "m", "v")}}]
    dist.broadcast_object_list(skeleton, src=0)
    skeleton = skeleton[0]
    if whole is None:
        whole = {"step": torch.tensor(skeleton["step"], dtype=torch.int32),
                 **{k: tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1],
                                                       device=device),
                                skeleton[k])
                    for k in ("params", "m", "v")}}
    for k in ("params", "m", "v"):
        for t in tree_leaves(whole[k]):
            dist.broadcast(t, src=0)
    return whole
