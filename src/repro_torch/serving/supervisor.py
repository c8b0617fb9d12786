"""Supervised multi-process serving: N worker processes, one referee (the
reference's ``repro/serving/supervisor.py``).

:class:`Supervisor` owns N :mod:`~repro_torch.serving.worker` processes
(each a full :class:`~repro_torch.serving.registry.ModelRegistry` with
its own CUDA context) and is the *sole* bookkeeper of the fleet
invariant::

    submitted == completed + shed + expired        (after drain)

Requests are dispatched round-robin over *live* workers.  Liveness is the
engines' :class:`~repro_torch.serving.health.HealthMonitor` ladder at
process level: every pump sends a heartbeat RPC; a miss is a recorded
failure, a reply a recorded ok, and a quarantined monitor means the worker
is declared dead: killed, respawned from its spec, its work failed over.
A broken pipe or a dead PID short-circuits the ladder.

Failover re-dispatch: the supervisor keeps every in-flight request's host
image.  When a worker dies, its queued and in-flight requests go to
survivors with their *remaining* deadline (already-expired ones retire as
expired); with no survivor they are parked until a worker comes back.  A
request leaves the supervisor's tables only through a retire record, an
expiry or a shed, never through a worker death.

Processes: workers start from the ``spawn`` context (CUDA cannot fork),
with ``PYTHONPATH`` naming this checkout's ``src``.  On the card the
parent builds the kernel library once before the first launch, so the
workers load it instead of each running ``nvcc``.  A worker whose ready
handshake names another device type than the one asked for is a spawn
failure, never a silent CPU worker.

Crash-consistent restart: a respawned worker rebuilds from its
:class:`~repro_torch.serving.worker.WorkerSpec` (params from the newest
intact checkpoint, slabs repacked, the plan cache reloaded), so it serves
bit-identical logits to the process it replaced.
:meth:`Supervisor.verify_bit_parity` closes the loop: served logits must
bit-match ``apply`` at the exact padded bucket each request was served in
(rebuilt from the ``served_bucket/row/group`` provenance), on the
supervisor's device, with the params a worker holds.

Chaos is seeded per worker (``derive_seed(seed, worker_name)``, one
:class:`~repro_torch.serving.faults.FaultInjector` each): ``worker.crash``
kills the process at a pump opportunity, ``worker.stall`` makes its
command loop sleep so heartbeats miss without the process dying.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import build
from .clock import MONOTONIC, Clock
from .faults import FaultInjector, FaultSpec, derive_seed
from .health import QUARANTINED, HealthMonitor
from .scheduler import DrainTimeout, LatencyTracker
from .worker import WorkerModel, WorkerSpec, load_params, worker_main

__all__ = ["Supervisor", "SupervisorConfig", "WorkerDead", "WorkerTimeout",
           "WorkerModel"]


class WorkerTimeout(RuntimeError):
    """An RPC to a worker exceeded its deadline (stall or overload): a
    heartbeat miss, not yet a death."""


class WorkerDead(RuntimeError):
    """The worker's pipe is gone or its process exited: hard failure."""


@dataclass(frozen=True)
class SupervisorConfig:
    n_workers: int = 2
    heartbeat_timeout_ms: float = 1000.0   # miss if no reply within this
    miss_threshold: int = 3                # consecutive misses -> dead
    rpc_timeout_ms: float = 60_000.0       # submit/step/retire budget
    spawn_timeout_s: float = 600.0         # build + warm-up budget
    steps_per_pump: int = 2                # registry ticks per step RPC
    max_restarts: int = 2                  # respawns per worker slot
    warm: bool = True                      # launch buckets before 'ready'
    checkpoint_on_start: bool = True       # seed a checkpoint pre-crash


@dataclass
class _Handle:
    """Parent-side state for one worker slot (survives respawns)."""
    name: str
    spec: WorkerSpec
    proc: Optional[mp.Process] = None
    conn: object = None
    monitor: Optional[HealthMonitor] = None
    injector: Optional[FaultInjector] = None
    seq: int = 0
    pid: Optional[int] = None
    restarts: int = 0
    alive: bool = False                 # ready and believed serving
    spawning: bool = False              # process launched, ready pending
    t_spawn: float = 0.0                # launch time (spawn_timeout clock)
    retired: bool = False               # restart budget exhausted
    restored: dict = field(default_factory=dict)   # model -> ckpt step
    device_name: Optional[str] = None   # the card the worker runs on
    last_accounting: dict = field(default_factory=dict)
    last_launches: dict = field(default_factory=dict)  # since its ready
    last_degradations: dict = field(default_factory=dict)
    deaths: List[str] = field(default_factory=list)
    # uid -> (model, supervisor-side ImageRequest record)
    inflight: Dict[int, Tuple[str, object]] = field(default_factory=dict)


def _src_root() -> str:
    # .../src/repro_torch/serving/supervisor.py -> .../src
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class Supervisor:
    """Own N worker processes; route, heartbeat, fail over, account."""

    def __init__(self, models: Sequence[WorkerModel],
                 sup: Optional[SupervisorConfig] = None, *,
                 ckpt_dir: Optional[str] = None,
                 seed: int = 0,
                 chaos: Optional[Dict[str, FaultSpec]] = None,
                 chaos_workers: Optional[Sequence[str]] = None,
                 clock: Optional[Clock] = None,
                 device="cuda"):
        self.models = tuple(models)
        self.sup = sup or SupervisorConfig()
        self.ckpt_dir = ckpt_dir
        self.seed = seed
        self.chaos = dict(chaos or {})
        self.clock = clock or MONOTONIC
        self.device = str(device)
        self._ctx = mp.get_context("spawn")
        # spawn children re-import repro_torch to unpickle the spec; make
        # sure they can even when the parent added src/ to sys.path itself
        root = _src_root()
        pp = os.environ.get("PYTHONPATH", "")
        if root not in pp.split(os.pathsep):
            os.environ["PYTHONPATH"] = (root + os.pathsep + pp) if pp else root

        self.workers: Dict[str, _Handle] = {}
        for k in range(self.sup.n_workers):
            name = f"w{k}"
            spec = WorkerSpec(name=name, models=self.models,
                              ckpt_dir=ckpt_dir, warm=self.sup.warm,
                              device=self.device)
            # chaos_workers narrows the blast radius: an "at opportunity s"
            # schedule would otherwise fire on every worker at once
            armed = self.chaos and (chaos_workers is None
                                    or name in chaos_workers)
            inj = (FaultInjector(derive_seed(seed, name), self.chaos)
                   if armed else None)
            self.workers[name] = _Handle(name=name, spec=spec, injector=inj)

        # fleet accounting: the supervisor's counters are authoritative;
        # the workers' are diagnostics (heartbeat snapshots)
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.failed_over = 0
        self.latency = LatencyTracker()
        # uid -> (model, req)
        self.requests: Dict[int, Tuple[str, object]] = {}
        self.pending: List[Tuple[str, object]] = []  # parked during outage
        self.failover_uids: set = set()
        self.events: List[dict] = []
        self._rr = 0                    # round-robin cursor
        self._started = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Supervisor":
        # one kernel build in the parent, which every worker then loads;
        # without a card the workers fail their build and report it
        if (torch.device(self.device).type == "cuda"
                and torch.cuda.is_available()
                and any(m.cfg.use_pallas or m.cfg.fc_bfp
                        for m in self.models)):
            build.library()
        # launch every worker first, then wait: the N builds run in parallel
        for h in self.workers.values():
            self._launch_proc(h)
        for h in self.workers.values():
            if not self._finalize_ready(h, block=True):
                self.shutdown()
                raise WorkerDead(f"{h.name}: failed to come up "
                                 f"({h.deaths[-1] if h.deaths else '?'})")
        if self.ckpt_dir and self.sup.checkpoint_on_start:
            self.checkpoint()
        self._started = True
        return self

    def __enter__(self) -> "Supervisor":
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.shutdown()

    def _fresh_monitor(self) -> HealthMonitor:
        # misses walk healthy -> degraded -> quarantined; quarantined ==
        # declared dead
        return HealthMonitor(
            fail_threshold=max(1, self.sup.miss_threshold - 1),
            quarantine_threshold=self.sup.miss_threshold)

    def _launch_proc(self, h: _Handle):
        """Start the worker process without waiting for its ready
        handshake: a build (torch import, CUDA context, params, warm-up)
        takes seconds, and the respawn path pumps survivors meanwhile."""
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=worker_main, args=(child, h.spec),
                                 daemon=True, name=f"serve-{h.name}")
        proc.start()
        child.close()
        h.proc, h.conn = proc, parent
        h.seq = 0
        h.alive, h.spawning = False, True
        h.t_spawn = time.monotonic()

    def _finalize_ready(self, h: _Handle, *, block: bool) -> bool:
        """Absorb the ready handshake.  ``block=False`` (pump path) polls
        and returns False while the build still runs; a build failure, a
        worker on the wrong device or a spawn timeout retires the attempt
        (counted against the restart budget)."""
        try:
            if not h.conn.poll(self.sup.spawn_timeout_s if block else 0):
                if (block or time.monotonic() - h.t_spawn
                        > self.sup.spawn_timeout_s):
                    self._spawn_failed(h, "no ready handshake within "
                                       f"{self.sup.spawn_timeout_s}s")
                return False
            ready = h.conn.recv()
        except (EOFError, OSError) as e:
            self._spawn_failed(h, f"{type(e).__name__}: {e}")
            return False
        if not ready.get("ok"):
            self._spawn_failed(h, f"build failed: "
                               f"{ready.get('error', 'unknown')}")
            return False
        if torch.device(ready["device"]).type != \
                torch.device(self.device).type:
            self._spawn_failed(h, f"worker came up on {ready['device']} "
                               f"({ready['device_name']}), not on "
                               f"{self.device}")
            return False
        h.pid = ready.get("pid")
        h.monitor = self._fresh_monitor()
        h.alive, h.spawning = True, False
        h.restored = dict(ready.get("restored") or {})
        h.device_name = ready["device_name"]
        h.last_launches = {}
        h.last_degradations = dict(ready["degradations"])
        self.events.append({"event": "spawn", "worker": h.name,
                            "pid": h.pid, "restarts": h.restarts,
                            "restored": h.restored,
                            "device_name": h.device_name,
                            "warmup_launches": ready["launches"],
                            "t": time.monotonic()})
        return True

    def _spawn_failed(self, h: _Handle, reason: str):
        h.spawning = False
        h.deaths.append(f"spawn-failed: {reason}")
        self.events.append({"event": "spawn-failed", "worker": h.name,
                            "reason": reason})
        if h.proc is not None:
            h.proc.kill()
            h.proc.join(timeout=10)
        if h.conn is not None:
            h.conn.close()
            h.conn = None
        if h.restarts < self.sup.max_restarts:
            h.restarts += 1
            self._launch_proc(h)
        else:
            h.retired = True
            self.events.append({"event": "retired", "worker": h.name})

    def shutdown(self):
        for h in self.workers.values():
            if h.conn is not None and h.alive:
                try:
                    self._rpc(h, {"op": "shutdown"}, timeout_s=5.0)
                except (WorkerDead, WorkerTimeout):
                    pass
            if h.proc is not None:
                if h.alive:             # it acked and is exiting
                    h.proc.join(timeout=5)
                if h.proc.is_alive():
                    h.proc.kill()
                    h.proc.join(timeout=5)
            if h.conn is not None:
                h.conn.close()
                h.conn = None
            h.alive = h.spawning = False

    # -- RPC ----------------------------------------------------------------
    def _rpc(self, h: _Handle, msg: dict, timeout_s: float) -> dict:
        """Seq-matched request/reply with a deadline.  Replies to RPCs that
        already timed out (a recovered stall) carry a stale seq and are
        dropped, never matched to the wrong call."""
        h.seq += 1
        msg = dict(msg, seq=h.seq)
        try:
            h.conn.send(msg)
            deadline = time.monotonic() + timeout_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not h.conn.poll(max(remaining, 0.0)):
                    raise WorkerTimeout(
                        f"{h.name}: no reply to {msg['op']!r} within "
                        f"{timeout_s * 1e3:.0f}ms")
                reply = h.conn.recv()
                if reply.get("seq") == h.seq:
                    return reply
        except (EOFError, BrokenPipeError, ConnectionResetError,
                OSError) as e:
            raise WorkerDead(
                f"{h.name}: {type(e).__name__}: {e}") from e

    def _send_only(self, h: _Handle, msg: dict):
        """Fire-and-forget (the chaos stall payload); the eventual reply is
        dropped by seq matching."""
        h.seq += 1
        try:
            h.conn.send(dict(msg, seq=h.seq))
        except (BrokenPipeError, OSError):
            pass

    # -- routing + submit ---------------------------------------------------
    def _live(self) -> List[_Handle]:
        return [h for h in self.workers.values()
                if h.alive and h.monitor is not None
                and h.monitor.state != QUARANTINED
                and h.proc is not None and h.proc.is_alive()]

    def _route(self, exclude: set) -> Optional[_Handle]:
        live = [h for h in self._live() if h.name not in exclude]
        if not live:
            return None
        h = live[self._rr % len(live)]
        self._rr += 1
        return h

    def submit(self, model: str, req) -> bool:
        """Dispatch one request to a live worker.  Returns False (and
        counts a shed) when every live worker refuses or none exists."""
        req.t_submit = self.clock.now()
        self.submitted += 1
        self.requests[req.uid] = (model, req)
        return self._dispatch(model, req, first=True)

    def _remaining_deadline_ms(self, req, now: float) -> Optional[float]:
        if req.deadline_ms is None:
            return None
        return req.deadline_ms - (now - req.t_submit) * 1e3

    def _dispatch(self, model: str, req, *, first: bool) -> bool:
        tried: set = set()
        while True:
            h = self._route(tried)
            if h is None:
                req.shed = True
                self.shed += 1
                return False
            remaining = self._remaining_deadline_ms(req, self.clock.now())
            if remaining is not None and remaining <= 0:
                self._expire(req, "deadline")
                return False
            try:
                rep = self._rpc(h, {"op": "submit", "model": model,
                                    "uid": req.uid, "image": req.image,
                                    "deadline_ms": remaining,
                                    "retries": req.retries},
                                timeout_s=self.sup.rpc_timeout_ms / 1e3)
            except WorkerDead as e:
                self._on_worker_death(h, str(e))
                tried.add(h.name)
                continue
            except WorkerTimeout:
                h.monitor.record_failure("submit-timeout")
                tried.add(h.name)
                continue
            if rep.get("accepted"):
                h.inflight[req.uid] = (model, req)
                if not first:
                    self.failed_over += 1
                    self.failover_uids.add(req.uid)
                return True
            tried.add(h.name)       # shed at this worker; try another

    def _expire(self, req, reason: str):
        req.expired = True
        req.expire_reason = reason
        self.expired += 1

    # -- death + failover ---------------------------------------------------
    def kill_worker(self, name: str, reason: str = "operator-kill"):
        """SIGKILL a worker (chaos, drills) and run the failover path."""
        h = self.workers[name]
        if h.proc is not None and h.proc.is_alive():
            h.proc.kill()
        self._on_worker_death(h, reason)

    def _on_worker_death(self, h: _Handle, reason: str):
        if not h.alive:
            return                          # already handled (re-entrant)
        h.alive = False
        h.deaths.append(reason)
        if h.monitor is not None and h.monitor.state != QUARANTINED:
            h.monitor.force_quarantine(reason)
        # the dead incarnation's launches, as of its last heartbeat
        self.events.append({"event": "death", "worker": h.name,
                            "pid": h.pid, "reason": reason,
                            "launches": dict(h.last_launches),
                            "t": time.monotonic()})
        if h.proc is not None:
            h.proc.kill()
            h.proc.join(timeout=10)
        if h.conn is not None:
            h.conn.close()
            h.conn = None
        orphans = list(h.inflight.values())
        h.inflight.clear()
        # failover re-dispatch FIRST, to survivors, at the remaining
        # deadline: the respawn takes seconds and must never gate them
        now = self.clock.now()
        for model, req in orphans:
            remaining = self._remaining_deadline_ms(req, now)
            if remaining is not None and remaining <= 0:
                self._expire(req, "deadline")
            elif self._live():
                self._dispatch(model, req, first=False)
            else:
                # total outage: park until a worker comes back
                self.pending.append((model, req))
        # crash-consistent restart, asynchronously; a later pump absorbs
        # the ready handshake
        if h.restarts < self.sup.max_restarts:
            h.restarts += 1
            self._launch_proc(h)
        else:
            h.retired = True
            self.events.append({"event": "retired", "worker": h.name})

    # -- pump ---------------------------------------------------------------
    def step(self):
        """One supervisory tick over every worker slot: respawn
        handshakes, chaos, liveness, heartbeat, registry steps,
        retirement, and re-dispatch of outage-parked requests."""
        for h in list(self.workers.values()):
            if h.spawning:
                self._finalize_ready(h, block=False)
            if h.retired or not h.alive:
                continue
            if h.injector is not None:
                if h.injector.fire("worker.crash"):
                    self.kill_worker(h.name, "chaos:worker.crash")
                    continue
                spec = h.injector.fire("worker.stall")
                if spec is not None and spec.delay_ms:
                    self._send_only(h, {"op": "stall",
                                        "delay_ms": spec.delay_ms})
            if h.proc is None or not h.proc.is_alive():
                self._on_worker_death(h, "process-exit")
                continue
            try:
                rep = self._rpc(h, {"op": "heartbeat"},
                                timeout_s=self.sup.heartbeat_timeout_ms / 1e3)
                h.monitor.record_ok()
                h.last_accounting = rep.get("accounting", {})
                h.last_launches = rep.get("launches", {})
                h.last_degradations = rep.get("degradations", {})
            except WorkerTimeout:
                h.monitor.record_failure("heartbeat-miss")
                if h.monitor.state == QUARANTINED:
                    self.kill_worker(h.name, "heartbeat-quarantine")
                continue
            except WorkerDead as e:
                self._on_worker_death(h, str(e))
                continue
            try:
                self._rpc(h, {"op": "step", "n": self.sup.steps_per_pump},
                          timeout_s=self.sup.rpc_timeout_ms / 1e3)
                rep = self._rpc(h, {"op": "retire_batch"},
                                timeout_s=self.sup.rpc_timeout_ms / 1e3)
            except WorkerTimeout:
                h.monitor.record_failure("rpc-timeout")
                if h.monitor.state == QUARANTINED:
                    self.kill_worker(h.name, "rpc-quarantine")
                continue
            except WorkerDead as e:
                self._on_worker_death(h, str(e))
                continue
            self._absorb_retirements(h, rep.get("results", []))
        if self.pending:
            if self._live():
                parked, self.pending = self.pending, []
                now = self.clock.now()
                for model, req in parked:
                    remaining = self._remaining_deadline_ms(req, now)
                    if remaining is not None and remaining <= 0:
                        self._expire(req, "deadline")
                    else:
                        self._dispatch(model, req, first=False)
            elif all(h.retired for h in self.workers.values()):
                # permanent outage: no capacity will return; shed
                # (reported, accounted) instead of hanging the drain
                parked, self.pending = self.pending, []
                for _model, req in parked:
                    req.shed = True
                    self.shed += 1

    def _absorb_retirements(self, h: _Handle, results: List[dict]):
        now = self.clock.now()
        for rec in results:
            ent = h.inflight.pop(rec["uid"], None)
            if ent is None:
                continue        # stale: the request failed over elsewhere
            model, req = ent
            if rec["status"] == "done":
                req.logits = rec["logits"]
                req.label = rec["label"]
                req.served_bucket = rec["bucket"]
                req.served_row = rec["row"]
                req.served_group = rec["group"]
                req.attempts = rec.get("attempts", req.attempts)
                req.done = True
                req.t_done = now
                self.completed += 1
                self.latency.record(now - req.t_submit)
            else:
                req.expire_reason = rec.get("expire_reason")
                req.expired = True
                self.expired += 1

    # -- drain + accounting -------------------------------------------------
    @property
    def in_flight(self) -> int:
        return (sum(len(h.inflight) for h in self.workers.values())
                + len(self.pending))

    @property
    def drained(self) -> bool:
        return self.in_flight == 0

    def run_until_done(self, max_steps: int = 10_000) -> dict:
        for _ in range(max_steps):
            if self.drained:
                return self.accounting()
            self.step()
            if not self._live() and not all(
                    h.retired for h in self.workers.values()):
                # total outage with respawns in flight: pumping costs
                # nothing, so back off instead of burning the step budget
                time.sleep(0.05)
        if self.drained:
            return self.accounting()
        raise DrainTimeout(
            f"fleet not drained after {max_steps} supervisor steps: "
            f"{self.accounting()}", self.accounting())

    def accounting(self) -> dict:
        """The fleet invariant, from the supervisor's own counters: no
        worker death may lose a request."""
        acc = {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "expired": self.expired,
            "in_flight": self.in_flight,
            "failed_over": self.failed_over,
        }
        acc["balanced"] = (self.submitted == self.completed + self.shed
                           + self.expired + self.in_flight)
        return acc

    def checkpoint(self) -> dict:
        """Persist every model's params via one live worker (they share
        seed-derived params, so one snapshot covers the fleet)."""
        live = self._live()
        if not live:
            raise WorkerDead("no live worker to checkpoint")
        return self._rpc(live[0], {"op": "checkpoint"},
                         timeout_s=self.sup.rpc_timeout_ms / 1e3)

    def stats(self) -> dict:
        per = {}
        for h in self.workers.values():
            per[h.name] = {
                "alive": h.alive,
                "retired": h.retired,
                "pid": h.pid,
                "restarts": h.restarts,
                "deaths": list(h.deaths),
                "restored": h.restored,
                "device_name": h.device_name,
                "inflight": len(h.inflight),
                "health": h.monitor.stats() if h.monitor else None,
                "chaos": h.injector.summary() if h.injector else None,
                "accounting": h.last_accounting,
                "launches": h.last_launches,
                "degradations": h.last_degradations,
            }
        return {"accounting": self.accounting(), "workers": per,
                "events": list(self.events),
                "latency": self.latency.percentiles_ms()}

    # -- failover bit-parity ------------------------------------------------
    def verify_bit_parity(self, *, uids: Optional[Sequence[int]] = None,
                          params: Optional[dict] = None) -> dict:
        """Check served logits against ``apply`` at the exact padded bucket
        each request was served in (rebuilt from the retire-time
        provenance), on the supervisor's device.  Defaults to every
        completed *failed-over* request.

        ``params``: optional {model: params}; defaults to what a worker
        holds: the newest intact checkpoint under ``ckpt_dir``, else
        ``init(seed)``.
        """
        from ..models import model_for

        dev = resolve_device(self.device)
        by_name = {m.name: m for m in self.models}
        if uids is None:
            uids = [u for u in sorted(self.failover_uids)
                    if self.requests[u][1].done]
        params = dict(params or {})
        oracle: Dict[tuple, np.ndarray] = {}   # one forward per group
        checked = mismatched = 0
        bad: List[int] = []
        for uid in uids:
            model, req = self.requests[uid]
            if not req.done or req.served_bucket is None:
                continue
            cfg = by_name[model].cfg
            mod = model_for(cfg)
            if model not in params:
                params[model] = load_params(by_name[model], self.ckpt_dir,
                                            dev)[0]
            key = (model, req.served_bucket, tuple(req.served_group))
            if key not in oracle:
                # staged as the engine stages: f32 images rounded on the
                # host to the model's dtype, padded rows zero
                buf = torch.zeros((req.served_bucket, cfg.image_size,
                                   cfg.image_size, cfg.in_channels),
                                  dtype=mod.DTYPES[cfg.dtype])
                for i, guid in enumerate(req.served_group):
                    buf[i] = torch.from_numpy(np.asarray(
                        self.requests[guid][1].image, np.float32))
                with torch.no_grad():
                    out = mod.apply(params[model], cfg, buf.to(dev))
                if cfg.sdc_abft:
                    out = out[0]            # (logits, ABFT verdict)
                oracle[key] = out.float().cpu().numpy()
            checked += 1
            if not np.array_equal(oracle[key][req.served_row],
                                  np.asarray(req.logits)):
                mismatched += 1
                bad.append(uid)
        return {"checked": checked, "mismatched": mismatched,
                "bad_uids": bad}
