"""Batched image-inference serving engine (the reference's
``repro/serving/cnn.py``), on PyTorch.

:class:`CnnEngine` runs the request-to-prediction path on top of the shared
:class:`SlotScheduler`:

* **Occupancy buckets** — each admitted group is padded to the next bucket
  (<= ``max_batch``); under an SLO (``slo_ms`` + ``dynamic_buckets``) a
  :class:`DynamicBucketPolicy` may insert sizes at the dominant group size.
  Padded rows are zeros and are sliced off before retirement.
* **Admission control** — ``slo_ms`` + ``admission`` sheds requests whose
  estimated wait busts the SLO or their own deadline.
* **Pack-once weight staging** — the model's weight slabs
  (``pack_serving_slabs``) are packed once per bucket shape and handed to
  every forward of that bucket.
* **Staged H2D** — each group's images go into a pinned host buffer and
  are copied to the card with ``non_blocking=True``, up to
  ``staging_depth`` groups ahead, so the copy of group N+1 overlaps the
  forward of group N.

Fault tolerance: seeded fault points (``stage.corrupt``,
``launch.transient``, ``launch.crash``, ``retire.nonfinite``,
``retire.latency``), deadlines and bounded retry with exponential backoff,
a health monitor / circuit breaker, and per-bucket degradation to the
``direct`` route after repeated datapath failures.  The accounting
invariant is ``submitted == completed + shed + expired`` once drained.

Only the injected launch faults and a device out-of-memory count as launch
failures.  A kernel that fails to build or launch (``KernelError``), and
an asynchronous device error surfacing at the logits fetch, propagate out
of :meth:`CnnEngine.step`: retrying cannot mend them, and degrading would
serve the ``direct`` route's library convolutions under the ``pallas``
route's name.  On the card, ``use_pallas`` builds the kernels when the
engine is made.

Not ported yet (they raise ``NotImplementedError``): ``data_parallel``,
``verify_slabs``, the model's ``sdc_abft``, and the ``slab.bitflip`` /
``slab.stale`` / ``retire.plausible`` fault points (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import build
from ..models import model_for
from .clock import MONOTONIC, Clock
from .faults import EngineCrash, FaultInjector, TransientLaunchError
from .health import QUARANTINED, HealthMonitor
from .policy import AdmissionController, DynamicBucketPolicy, bucket_sizes
from .scheduler import DrainTimeout, LatencyTracker, SlotScheduler

__all__ = ["CnnEngine", "CnnServeConfig", "ImageRequest", "bucket_sizes"]

# fault points whose defenses (ABFT, slab fingerprints, magnitude screen
# chaos) come with a later slice of the port
_UNPORTED_FAULTS = ("slab.bitflip", "slab.stale", "retire.plausible")
# launch failures the retry/degrade ladder handles; everything else raised
# by a forward propagates
_TRANSIENT_LAUNCH = (TransientLaunchError, torch.cuda.OutOfMemoryError)


@dataclass
class CnnServeConfig:
    max_batch: int = 8          # largest serve bucket (paper's S_batch knob)
    staging_depth: int = 2      # groups staged ahead of compute
    data_parallel: bool = False  # not ported yet
    # -- SLO control plane (serving/policy.py) --------------------------
    slo_ms: Optional[float] = None
    dynamic_buckets: bool = False
    admission: bool = False
    max_extra_buckets: int = 2
    policy_window: int = 64
    admission_slack: float = 1.0
    latency_window: int = 4096
    # -- fault tolerance (serving/faults.py + serving/health.py) --------
    retry_backoff_ms: float = 1.0
    screen_sample: int = 8
    fail_threshold: int = 3
    quarantine_threshold: int = 6
    cooldown_ms: float = 250.0
    degrade_threshold: int = 3
    # -- SDC defense ----------------------------------------------------
    verify_slabs: bool = False      # not ported yet
    screen_abs_max: Optional[float] = None  # |logit| bound on the screen


@dataclass
class ImageRequest:
    image: np.ndarray           # (H, W, C) host-side float image
    uid: int = field(default_factory=itertools.count().__next__)
    deadline_ms: Optional[float] = None  # relative to submit; None = none
    retries: int = 2
    attempts: int = 0
    logits: Optional[np.ndarray] = None
    label: Optional[int] = None
    done: bool = False
    shed: bool = False
    expired: bool = False
    expire_reason: Optional[str] = None   # "deadline" | "retries"
    t_submit: float = 0.0
    t_done: float = 0.0
    # serving provenance: padded bucket, row in it, and the group's uids in
    # row order — enough to rebuild the exact padded batch
    served_bucket: Optional[int] = None
    served_row: Optional[int] = None
    served_group: Optional[Tuple[int, ...]] = None


@dataclass
class _Group:
    """One admitted batch moving through the stage->compute->retire pipe."""
    slots: List[int]
    reqs: List[ImageRequest]
    bucket: int
    images: object              # device tensor (bucket, H, W, C)
    host: object = None         # pinned source of an in-flight H2D copy
    logits: object = None       # device tensor once the forward is issued
    t_launch: float = 0.0
    first_compile: bool = False  # first launch of this bucket shape


def _check_faults(faults: Optional[FaultInjector]):
    if faults is not None:
        armed = sorted(set(faults.specs) & set(_UNPORTED_FAULTS))
        if armed:
            raise NotImplementedError(
                f"fault points {armed} are not ported yet (ROADMAP Queue 1, "
                "item 1: ABFT/SDC in kernels 1-3)")


class CnnEngine:
    def __init__(self, cfg, scfg: CnnServeConfig, *, params=None,
                 seed: int = 0, faults: Optional[FaultInjector] = None,
                 clock: Optional[Clock] = None, device="cuda"):
        if scfg.data_parallel:
            raise NotImplementedError("data_parallel is not ported yet "
                                      "(ROADMAP Queue 1, item 6)")
        if scfg.verify_slabs:
            raise NotImplementedError("verify_slabs is not ported yet "
                                      "(ROADMAP Queue 1, item 1)")
        _check_faults(faults)
        self.device = resolve_device(device)
        if cfg.use_pallas and self.device.type == "cuda":
            build.library()     # a kernel that cannot build fails here
        self.cfg, self.scfg = cfg, scfg
        self.clock = clock or MONOTONIC
        self.mod = model_for(cfg)
        if params is None:
            params = self.mod.init(seed, cfg, device=self.device)
        self.params = params
        self._buckets = bucket_sizes(scfg.max_batch)
        self.sched = SlotScheduler(scfg.max_batch * scfg.staging_depth)

        self.policy = (DynamicBucketPolicy(
            scfg.max_batch, scfg.slo_ms, max_extra=scfg.max_extra_buckets,
            window=scfg.policy_window)
            if scfg.slo_ms and scfg.dynamic_buckets else None)
        self.admission = (AdmissionController(
            scfg.slo_ms, slack=scfg.admission_slack)
            if scfg.slo_ms and scfg.admission else None)

        self.faults = faults
        self.health = HealthMonitor(
            fail_threshold=scfg.fail_threshold,
            quarantine_threshold=scfg.quarantine_threshold,
            cooldown_ms=scfg.cooldown_ms,
            clock=self.clock)

        # route degradation ladder: the direct-route twin config a bucket
        # falls back to after repeated datapath failures
        self._primary_route = (
            "pallas" if cfg.use_pallas
            else ("winograd" if cfg.use_winograd else "direct"))
        self._cfg_direct = (
            dataclasses.replace(cfg, use_winograd=False, use_pallas=False)
            if self._primary_route != "direct" else None)
        self._degraded: Set[int] = set()
        self._bucket_failures: Dict[int, int] = {}
        self.degradations: List[dict] = []

        self.plans: Dict[str, object] = self.mod.load_tuned_plans(
            cfg, scfg.max_batch)
        self._packed: Dict[int, dict] = {}
        self._packed_direct: Dict[int, dict] = {}
        self._launched: set = set()
        self._launched_direct: set = set()
        self.screen_nonfinite = 0
        self.screen_magnitude = 0
        self._staged: Deque[_Group] = deque()
        self._compute: Deque[_Group] = deque()
        self._retry: List[Tuple[float, List[ImageRequest]]] = []
        self.latency = LatencyTracker(window=scfg.latency_window)
        self.images_submitted = 0
        self.images_completed = 0
        self.images_shed = 0
        self.images_expired = 0
        self.images_retried = 0
        self.images_within_slo = 0
        self.batches_run = 0
        self.batches_failed = 0
        self.bucket_counts: Dict[int, int] = {}
        self.shed_reasons: Dict[str, int] = {}
        self._t_serve = 0.0

    # ------------------------------------------------------------------
    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.policy.buckets() if self.policy else self._buckets

    def _validate(self, req: ImageRequest):
        expect = (self.cfg.image_size, self.cfg.image_size,
                  self.cfg.in_channels)
        shape = np.shape(req.image)
        if shape != expect:
            raise ValueError(f"image shape {shape} != expected {expect} "
                             f"for {self.cfg.name}")

    def submit(self, req: ImageRequest):
        """Unconditional submit (no admission control)."""
        self._validate(req)
        req.t_submit = self.clock.now()
        self.images_submitted += 1
        self.sched.submit(req)

    def backlog_images(self) -> int:
        return (len(self.sched.queue)
                + sum(len(g.reqs) for g in self._staged)
                + sum(len(g.reqs) for g in self._compute)
                + self.retry_pending)

    def shed(self, req: ImageRequest, reason: str = "admission"):
        req.shed = True
        self.images_submitted += 1
        self.images_shed += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1

    def try_submit(self, req: ImageRequest) -> bool:
        """Admission-controlled submit: False (and ``req.shed``) when the
        engine is quarantined or the SLO controller would shed it."""
        self._validate(req)
        if self.health.state == QUARANTINED:
            self.shed(req, "unhealthy")
            return False
        if (self.admission is not None
                and not self.admission.admit(self.backlog_images(),
                                             deadline_ms=req.deadline_ms)):
            self.shed(req, "admission")
            return False
        req.t_submit = self.clock.now()
        self.images_submitted += 1
        self.sched.submit(req)
        return True

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests (raises past max_batch)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"group of {n} exceeds max_batch={self.buckets[-1]}; "
            f"admission must cap groups at the largest bucket")

    def _put(self, host: np.ndarray):
        """(device tensor, pinned source): an async H2D copy from a pinned
        buffer on the card; the source must live until the copy is done."""
        src = torch.from_numpy(host)
        if self.device.type != "cuda":
            return src.to(self.device), None
        src = src.pin_memory()
        return src.to(self.device, non_blocking=True), src

    def _slabs(self, bucket: int):
        """Pack-once weight slabs for one bucket shape."""
        if bucket not in self._packed:
            self._packed[bucket] = self.mod.pack_serving_slabs(
                self.params, self.cfg, bucket, plans=self.plans)
        return self._packed[bucket]

    def _slabs_direct(self, bucket: int):
        if bucket not in self._packed_direct:
            self._packed_direct[bucket] = self.mod.pack_serving_slabs(
                self.params, self._cfg_direct, bucket)
        return self._packed_direct[bucket]

    # -- fault-tolerance internals -------------------------------------
    def _is_expired(self, req: ImageRequest, now: float) -> bool:
        return (req.deadline_ms is not None
                and now >= req.t_submit + req.deadline_ms / 1e3)

    def _retire_expired(self, req: ImageRequest, reason: str):
        req.expired = True
        req.expire_reason = reason
        self.images_expired += 1

    def _schedule_retry(self, reqs: List[ImageRequest], now: float):
        if not reqs:
            return
        attempt = min(r.attempts for r in reqs)
        delay_s = (self.scfg.retry_backoff_ms
                   * (2 ** max(attempt - 1, 0))) / 1e3
        self._retry.append((now + delay_s, reqs))
        self.images_retried += len(reqs)

    def _fail_one(self, slot: int, req: ImageRequest, now: float,
                  retry: List[ImageRequest]):
        self.sched.release(slot)
        req.attempts += 1
        if self._is_expired(req, now):
            self._retire_expired(req, "deadline")
        elif req.attempts > req.retries:
            self._retire_expired(req, "retries")
        else:
            retry.append(req)

    def _requeue_group(self, g: _Group):
        now = self.clock.now()
        retry: List[ImageRequest] = []
        for slot, req in zip(g.slots, g.reqs):
            self._fail_one(slot, req, now, retry)
        self._schedule_retry(retry, now)

    def _pump_retries(self):
        if not self._retry:
            return
        now = self.clock.now()
        ready = [e for e in self._retry if e[0] <= now]
        if not ready:
            return
        self._retry = [e for e in self._retry if e[0] > now]
        for _, reqs in sorted(ready, key=lambda e: e[0], reverse=True):
            live = []
            for r in reqs:
                if self._is_expired(r, now):
                    self._retire_expired(r, "deadline")
                else:
                    live.append(r)
            if live:
                self.sched.requeue(live)

    def _note_datapath_failure(self, bucket: int, kind: str):
        if self._cfg_direct is None or bucket in self._degraded:
            return
        n = self._bucket_failures.get(bucket, 0) + 1
        self._bucket_failures[bucket] = n
        if n >= self.scfg.degrade_threshold:
            self._degraded.add(bucket)
            self.degradations.append({
                "bucket": bucket, "reason": kind, "failures": n,
                "from": self._primary_route, "to": "direct"})

    def _screen(self, logits: np.ndarray) -> np.ndarray:
        """Sampled screen on retired logits: True = row may be served
        (finite, and within ``screen_abs_max`` when set)."""
        n = len(logits)
        ok = np.ones(n, bool)
        k = self.scfg.screen_sample
        if not n or k <= 0:
            return ok
        idx = (np.arange(n) if k >= n
               else np.unique(np.linspace(0, n - 1, k).astype(int)))
        rows = logits[idx].astype(np.float32)
        finite = np.isfinite(rows).all(axis=1)
        self.screen_nonfinite += int((~finite).sum())
        ok[idx] = finite
        amax = self.scfg.screen_abs_max
        if amax is not None:
            bounded = (np.abs(np.where(np.isfinite(rows), rows, 0.0))
                       .max(axis=1) <= amax)
            self.screen_magnitude += int((finite & ~bounded).sum())
            ok[idx] &= bounded
        return ok

    def _quarantine_purge(self):
        now = self.clock.now()
        while self._staged:
            g = self._staged.popleft()
            live = []
            for slot, req in zip(g.slots, g.reqs):
                self.sched.release(slot)
                if self._is_expired(req, now):
                    self._retire_expired(req, "deadline")
                else:
                    live.append(req)
            if live:
                self.sched.requeue(live)
        q = self.sched.queue
        for _ in range(len(q)):
            r = q.popleft()
            if self._is_expired(r, now):
                self._retire_expired(r, "deadline")
            else:
                q.append(r)

    # -- pipeline ------------------------------------------------------
    def _stage(self):
        """Admit queued requests into free slots and start their H2D
        copies; requests already past their deadline retire as expired."""
        while (self.sched.queue and
               len(self._staged) + len(self._compute) < self.scfg.staging_depth):
            group = self.sched.admit(limit=self.scfg.max_batch)
            if not group:
                break
            now = self.clock.now()
            slots, reqs = [], []
            for s, r in group:
                if self._is_expired(r, now):
                    self.sched.release(s)
                    self._retire_expired(r, "deadline")
                else:
                    slots.append(s)
                    reqs.append(r)
            if not reqs:
                continue
            if self.policy is not None:
                self.policy.observe_admit(len(reqs))
            bucket = self.bucket_for(len(reqs))
            h, w, c = reqs[0].image.shape
            buf = np.zeros((bucket, h, w, c), np.float32)
            for i, r in enumerate(reqs):
                buf[i] = r.image
            if self.faults is not None and self.faults.fire("stage.corrupt"):
                buf[0] = np.nan     # the staged copy only; req.image stays
            images, host = self._put(buf)
            self._staged.append(_Group(slots, reqs, bucket, images, host))

    def _forward(self, g: _Group, degraded: bool):
        if degraded:
            return self.mod.apply(self.params, self._cfg_direct, g.images,
                                  packed=self._slabs_direct(g.bucket))
        return self.mod.apply(self.params, self.cfg, g.images,
                              plans=self.plans,
                              packed=self._slabs(g.bucket))

    def _launch(self):
        """Issue the forward for the oldest staged group.  Injected launch
        faults and a device out-of-memory re-queue the group and feed the
        health monitor; any other error (a ``KernelError`` among them)
        propagates."""
        if not self._staged:
            return
        g = self._staged.popleft()
        degraded = g.bucket in self._degraded
        launched = self._launched_direct if degraded else self._launched
        g.first_compile = g.bucket not in launched
        g.t_launch = self.clock.now()
        try:
            if self.faults is not None:
                if self.faults.fire("launch.crash"):
                    raise EngineCrash("injected hard engine crash")
                if self.faults.fire("launch.transient"):
                    raise TransientLaunchError(
                        "injected transient launch failure "
                        "(RESOURCE_EXHAUSTED)")
            g.logits = self._forward(g, degraded)
        except EngineCrash as e:
            self.batches_failed += 1
            self.health.force_quarantine(f"crash: {e}")
            self._note_datapath_failure(g.bucket, "crash")
            self._requeue_group(g)
            return
        except _TRANSIENT_LAUNCH:
            self.batches_failed += 1
            self.health.record_failure("launch")
            self._note_datapath_failure(g.bucket, "launch")
            self._requeue_group(g)
            return
        launched.add(g.bucket)
        self._compute.append(g)

    def _finish_oldest(self):
        """Wait for the oldest issued group and retire its requests; rows
        failing the screen retry, clean rows retire."""
        if not self._compute:
            return
        g = self._compute.popleft()
        # an async device error surfaces here and propagates: it leaves the
        # CUDA context unusable, so no retry or route could serve the group
        logits = g.logits.cpu().numpy()[: len(g.reqs)]
        g.host = None
        if self.faults is not None:
            spec = self.faults.fire("retire.latency")
            if spec is not None and spec.delay_ms:
                self.clock.sleep(spec.delay_ms / 1e3)
            if self.faults.fire("retire.nonfinite"):
                logits = np.array(logits)
                logits[0] = np.nan
        ok = self._screen(logits)
        now = self.clock.now()
        slo_s = (self.scfg.slo_ms or 0.0) / 1e3
        n_good = 0
        retry: List[ImageRequest] = []
        group_uids = tuple(r.uid for r in g.reqs)
        for i, (slot, req, row, good) in enumerate(
                zip(g.slots, g.reqs, logits, ok)):
            if not good:
                self._fail_one(slot, req, now, retry)
                continue
            req.logits = row
            req.label = int(row.argmax())
            req.done = True
            req.t_done = now
            req.served_bucket = g.bucket
            req.served_row = i
            req.served_group = group_uids
            lat = now - req.t_submit
            self.latency.record(lat)
            if slo_s and lat <= slo_s:
                self.images_within_slo += 1
            if self.policy is not None:
                self.policy.observe_latency(lat)
            self.sched.retire(slot)
            n_good += 1
        self._schedule_retry(retry, now)
        if n_good == len(g.reqs):
            self.health.record_ok()
            self._bucket_failures[g.bucket] = 0
        else:
            self.health.record_failure("nonfinite")
            self._note_datapath_failure(g.bucket, "nonfinite")
        # a bucket's first batch carries the slab packing (and, on the card,
        # the kernels' first launch) and would poison the service estimate
        if self.admission is not None and not g.first_compile and n_good:
            self.admission.observe_batch(n_good, now - g.t_launch)
        if self.policy is not None:
            self.policy.maybe_resize()
        self.images_completed += n_good
        self.batches_run += 1
        self.bucket_counts[g.bucket] = self.bucket_counts.get(g.bucket, 0) + 1

    def step(self):
        """One tick: pump retries, stage ahead (H2D), launch the oldest
        staged group, retire the oldest issued one."""
        t0 = self.clock.now()
        self._pump_retries()
        if self.health.state == QUARANTINED:
            self._quarantine_purge()
            if (self.sched.queue
                    and len(self._staged) + len(self._compute)
                    < self.scfg.staging_depth
                    and self.health.allow_launch()):
                self._stage()
                if self._staged:
                    self._launch()              # the half-open probe
                else:
                    self.health.cancel_probe()
        else:
            self._stage()
            self._launch()
        self._finish_oldest()
        self._t_serve += self.clock.now() - t0

    @property
    def retry_pending(self) -> int:
        return sum(len(rs) for _, rs in self._retry)

    @property
    def drained(self) -> bool:
        return (self.sched.idle and not self._staged and not self._compute
                and not self._retry)

    def drain_report(self) -> dict:
        return {
            "drained": self.drained,
            "queued": len(self.sched.queue),
            "staged": sum(len(g.reqs) for g in self._staged),
            "computing": sum(len(g.reqs) for g in self._compute),
            "retry_pending": self.retry_pending,
            "occupancy": self.sched.occupancy,
            "health": self.health.state,
        }

    def run_until_done(self, max_steps: int = 100_000) -> dict:
        """Step until drained; raises :class:`DrainTimeout` otherwise."""
        for _ in range(max_steps):
            if self.drained:
                return self.drain_report()
            self.step()
        if self.drained:
            return self.drain_report()
        report = self.drain_report()
        raise DrainTimeout(
            f"engine not drained after {max_steps} steps: {report}", report)

    def export_state(self) -> dict:
        """Host-side snapshot a restart must persist: the params, numpy."""
        return {"params": self.mod.params_to_numpy(self.params)}

    def reset_metrics(self):
        """Zero throughput/latency counters, keeping queue, slabs, health
        and admission state."""
        self.latency = LatencyTracker(window=self.scfg.latency_window)
        self.images_submitted = 0
        self.images_completed = 0
        self.images_shed = 0
        self.images_expired = 0
        self.images_retried = 0
        self.images_within_slo = 0
        self.batches_run = 0
        self.batches_failed = 0
        self.bucket_counts = {}
        self.shed_reasons = {}
        self.screen_nonfinite = 0
        self.screen_magnitude = 0
        self._t_serve = 0.0

    # ------------------------------------------------------------------
    @property
    def imgs_per_s(self) -> float:
        return self.images_completed / self._t_serve if self._t_serve else 0.0

    @property
    def goodput_imgs_per_s(self) -> float:
        if not self._t_serve:
            return 0.0
        good = (self.images_within_slo if self.scfg.slo_ms
                else self.images_completed)
        return good / self._t_serve

    def accounting(self) -> dict:
        """Every submitted image is completed, shed, expired or in flight."""
        in_flight = (len(self.sched.queue)
                     + sum(len(g.reqs) for g in self._staged)
                     + sum(len(g.reqs) for g in self._compute)
                     + self.retry_pending)
        accounted = (self.images_completed + self.images_shed
                     + self.images_expired + in_flight)
        return {
            "submitted": self.images_submitted,
            "completed": self.images_completed,
            "shed": self.images_shed,
            "expired": self.images_expired,
            "in_flight": in_flight,
            "balanced": self.images_submitted == accounted,
            "screen_nonfinite": self.screen_nonfinite,
            "screen_magnitude": self.screen_magnitude,
        }

    def stats(self) -> dict:
        return {
            "images_completed": self.images_completed,
            "images_shed": self.images_shed,
            "images_expired": self.images_expired,
            "images_retried": self.images_retried,
            "images_within_slo": (self.images_within_slo
                                  if self.scfg.slo_ms else None),
            "batches_run": self.batches_run,
            "batches_failed": self.batches_failed,
            "avg_occupancy": (self.images_completed / self.batches_run
                              if self.batches_run else 0.0),
            "bucket_counts": dict(sorted(self.bucket_counts.items())),
            "buckets": list(self.buckets),
            "bucket_resizes": list(self.policy.resizes) if self.policy else [],
            "imgs_per_s": self.imgs_per_s,
            "goodput_imgs_per_s": self.goodput_imgs_per_s,
            "latency_ms": self.latency.percentiles_ms(),
            "tuned_layers": sorted(self.plans),
            "health": self.health.stats(),
            "shed_reasons": dict(self.shed_reasons),
            "degraded_buckets": sorted(self._degraded),
            "degradations": list(self.degradations),
            "faults": self.faults.summary() if self.faults else None,
            "accounting": self.accounting(),
        }
