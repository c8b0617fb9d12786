"""Serving worker process: a :class:`ModelRegistry` behind a pickled pipe
(the reference's ``repro/serving/worker.py``).

Each worker is a separate OS process owning its own CUDA context, packed
weight slabs and :class:`~repro_torch.serving.registry.ModelRegistry`, so
one worker's crash, stall or leak cannot take down the rest of the fleet.
It loads the kernel library the parent built (``kernels/build.py`` reuses
a build of the same sources).  The parent-side
:class:`~repro_torch.serving.supervisor.Supervisor` owns N of these and
speaks the request/reply protocol below over a duplex
``multiprocessing.Pipe``; messages are plain dicts and numpy arrays,
never a CUDA tensor.

Protocol (every request carries a ``seq`` that the reply echoes, so a
reply that arrives after its RPC timed out, from a recovered stall, is
recognised and dropped):

==================  ======================================================
``submit``          enqueue one request ``{model, uid, image, deadline_ms,
                    retries}`` through the engine's admission control;
                    reply ``{accepted}`` (False = shed at the worker)
``step``            tick the registry ``n`` times; reply ``{drained}``
``retire_batch``    pop every finished request; reply ``{results: [...]}``
                    with, per request, uid, status (``done``/``expired``),
                    logits (float32) and label or expire_reason, and the
                    serving provenance (``bucket``/``row``/``group``) that
                    rebuilds the exact padded batch
``heartbeat``       liveness probe; reply: queue depth, each model's
                    accounting and degradations, the card's name and the
                    kernel launch counts since the worker became ready
``checkpoint``      persist every model's params (crc32 manifest, atomic
                    publish) under ``<ckpt_dir>/<model>/``; reply
                    ``{paths, step}``
``stall``           chaos payload (``worker.stall``): sleep ``delay_ms``
                    before replying, so the supervisor's heartbeat
                    deadline trips without the process dying
``shutdown``        ack, close the pipe, exit
==================  ======================================================

The ready handshake reports the worker's device and card name, the
restored checkpoint step of each model, the kernel launches of its
warm-up, and each engine's degradations; the launch counts are then set
to 0.

Crash-consistent restart: at build each model's params come from the
newest *intact* checkpoint under ``<ckpt_dir>/<model>/`` (crc-verified;
a torn latest step is skipped with a warning), in the model's dtype,
else from ``init(seed)``.  Either way the respawned worker repacks its
slabs and loads the persisted plan cache, so it serves bit-identical
logits to the one that died.  The worker exits on a closed pipe
(supervisor death): no orphan process holds the card.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt
from ..kernels.bfp_matmul import ops as bfp_ops
from ..kernels.conv import ops as conv_ops
from ..models import model_for
from .cnn import ImageRequest
from .registry import ModelRegistry

__all__ = ["WorkerModel", "WorkerSpec", "worker_main"]


@dataclass(frozen=True)
class WorkerModel:
    """One model a worker serves: everything needed to rebuild its engine
    in a fresh process (spawn pickles this)."""
    name: str
    cfg: object                     # model config (frozen dataclass)
    scfg: object                    # CnnServeConfig
    seed: int = 0


@dataclass(frozen=True)
class WorkerSpec:
    """A worker's full build recipe: respawn == spawn(same spec)."""
    name: str
    models: Tuple[WorkerModel, ...]
    ckpt_dir: Optional[str] = None  # model params under <ckpt_dir>/<model>/
    warm: bool = True               # launch every bucket before 'ready'
    slot_budget: Optional[int] = None
    keep_checkpoints: int = 3
    device: str = "cuda"


@dataclass
class _WorkerState:
    registry: ModelRegistry
    params: dict                    # model -> params
    restored: dict                  # model -> restored step (None = init)
    device: torch.device
    live: Dict[int, tuple] = field(default_factory=dict)  # uid -> (model, req)
    ckpt_step: int = 0              # the last step this worker wrote


def _model_ckpt_dir(spec: WorkerSpec, model: str) -> Optional[str]:
    return os.path.join(spec.ckpt_dir, model) if spec.ckpt_dir else None


def _launch_counts() -> dict:
    """The image path's CUDA-kernel launches in this process, by kernel."""
    return {**conv_ops.launch_counts(), **bfp_ops.launch_counts()}


def _reset_launch_counts():
    conv_ops.reset_launch_counts()
    bfp_ops.reset_launch_counts()


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def load_params(wm: WorkerModel, ckpt_dir: Optional[str], device):
    """(params, restored step) of one model on ``device``: the newest
    intact checkpoint under ``<ckpt_dir>/<model>/`` in the model's dtype,
    else ``init(seed)``."""
    mod = model_for(wm.cfg)
    d = os.path.join(ckpt_dir, wm.name) if ckpt_dir else None
    step = ckpt.latest_intact_step(d) if d else None
    if step is None:
        return mod.init(wm.seed, wm.cfg, device=device), None
    # the intact-step scan already skipped a torn latest step
    like = mod.empty_params(wm.cfg, device=device)
    got = ckpt.restore(d, {"step": 0, "params": like}, step=step)["params"]
    return {layer: {k: got[layer][k].to(v.dtype) for k, v in sub.items()}
            for layer, sub in like.items()}, step


def _build(spec: WorkerSpec) -> _WorkerState:
    """Registry construction, crash-consistent param recovery, warm-up."""
    reg = ModelRegistry(slot_budget=spec.slot_budget)
    params, restored = {}, {}
    for wm in spec.models:
        params[wm.name], restored[wm.name] = load_params(
            wm, spec.ckpt_dir, spec.device)
        eng = reg.register(wm.name, wm.cfg, wm.scfg, params=params[wm.name],
                           seed=wm.seed, device=spec.device)
        if spec.warm:
            rng = np.random.default_rng(wm.seed)
            for b in eng.buckets:
                for _ in range(b):
                    eng.submit(ImageRequest(image=rng.standard_normal(
                        (wm.cfg.image_size, wm.cfg.image_size,
                         wm.cfg.in_channels)).astype(np.float32)))
                eng.run_until_done()
            eng.reset_metrics()
    return _WorkerState(registry=reg, params=params, restored=restored,
                        device=torch.device(spec.device))


def _retire_batch(st: _WorkerState) -> list:
    """Drain every terminal request out of the live table."""
    out = []
    for uid in list(st.live):
        model, req = st.live[uid]
        if req.done:
            out.append({"uid": uid, "model": model, "status": "done",
                        "logits": np.asarray(req.logits, np.float32),
                        "label": req.label,
                        "bucket": req.served_bucket,
                        "row": req.served_row,
                        "group": req.served_group,
                        "attempts": req.attempts})
        elif req.expired:
            out.append({"uid": uid, "model": model, "status": "expired",
                        "expire_reason": req.expire_reason,
                        "attempts": req.attempts})
        else:
            continue
        del st.live[uid]
    return out


def _accounting(st: _WorkerState) -> dict:
    return {name: eng.accounting()
            for name, eng in st.registry.engines.items()}


def _report(st: _WorkerState) -> dict:
    """What the ready handshake and every heartbeat carry."""
    return {"device": str(st.device), "device_name": _device_name(st.device),
            "launches": _launch_counts(),
            "degradations": {name: list(eng.degradations)
                             for name, eng in st.registry.engines.items()}}


def worker_main(conn, spec: WorkerSpec) -> None:
    """Child-process entry point (top-level so ``spawn`` can import it)."""
    try:
        st = _build(spec)
    except BaseException as e:          # surface build failures to parent
        try:
            conn.send({"op": "ready", "ok": False, "worker": spec.name,
                       "error": f"{type(e).__name__}: {e}"})
        finally:
            conn.close()
        raise
    conn.send({"op": "ready", "ok": True, "worker": spec.name, "pid":
               os.getpid(), "models": [m.name for m in spec.models],
               "restored": st.restored, **_report(st)})
    _reset_launch_counts()

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):     # supervisor died: don't linger
            return
        op = msg.get("op")
        reply = {"op": op, "seq": msg.get("seq"), "worker": spec.name}
        if op == "submit":
            req = ImageRequest(image=msg["image"], uid=msg["uid"],
                               deadline_ms=msg.get("deadline_ms"),
                               retries=msg.get("retries", 2))
            accepted = st.registry.submit(msg["model"], req)
            if accepted:
                st.live[req.uid] = (msg["model"], req)
            reply.update(accepted=accepted)
        elif op == "step":
            for _ in range(max(int(msg.get("n", 1)), 1)):
                st.registry.step()
            reply.update(drained=st.registry.idle)
        elif op == "retire_batch":
            reply.update(results=_retire_batch(st))
        elif op == "heartbeat":
            reply.update(alive=True, pid=os.getpid(),
                         inflight=len(st.live),
                         accounting=_accounting(st), **_report(st))
        elif op == "checkpoint" and not spec.ckpt_dir:
            reply.update(error="checkpoint: the worker has no ckpt_dir")
        elif op == "checkpoint":
            # after the newest step on disk, whichever worker wrote it: a
            # respawned worker never overwrites the step it was built from
            st.ckpt_step = 1 + max([st.ckpt_step] + [
                ckpt.latest_step(_model_ckpt_dir(spec, name)) or 0
                for name in st.params])
            paths = {}
            for name, p in st.params.items():
                paths[name] = ckpt.save(
                    _model_ckpt_dir(spec, name),
                    {"step": st.ckpt_step, "params": p},
                    keep=spec.keep_checkpoints)
            reply.update(paths=paths, step=st.ckpt_step)
        elif op == "stall":
            time.sleep(msg.get("delay_ms", 0.0) / 1e3)
            reply.update(stalled_ms=msg.get("delay_ms", 0.0))
        elif op == "shutdown":
            reply.update(bye=True)
            try:
                conn.send(reply)
            finally:
                conn.close()
            return
        else:
            reply.update(error=f"unknown op {op!r}")
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return
