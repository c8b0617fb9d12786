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
* **Staged H2D** — each group's images go into a pinned host buffer in
  the model's dtype (``_buf_dtype``: a bf16 model stages bf16, half the
  bytes) and are copied to the card with ``non_blocking=True``, up to
  ``staging_depth`` groups ahead, so the copy of group N+1 overlaps the
  forward of group N.
* **SLO control plane on a live engine** — :meth:`CnnEngine.arm_slo`
  attaches (or replaces, or removes) the SLO policy and admission control
  after a warm-up, keeping the packed slabs and the counters, so a
  deployment can set its SLO from measured service times.

Fault tolerance: seeded fault points (``stage.corrupt``,
``launch.transient``, ``launch.crash``, ``retire.nonfinite``,
``retire.latency``), deadlines and bounded retry with exponential backoff,
a health monitor / circuit breaker, and per-bucket degradation to the
``direct`` route after repeated datapath failures.  The accounting
invariant is ``submitted == completed + shed + expired`` once drained.

Silent-data-corruption defense: under the model's ``sdc_abft`` every
forward returns an ABFT verdict from the armed conv kernels, read at
retire after the logits' copy; a positive verdict means a staged slab's
bits changed after packing, so the batch is never served: the bucket's
slabs are repacked from the pristine params and the group retries
(``sdc_detections``).  ``verify_slabs`` checks the staged slabs'
fingerprints (shape, dtype, crc32, pack context) before every dispatch
(``slab_integrity_failures``), and ``screen_abs_max`` bounds the retired
logits' magnitude (``screen_magnitude``).  The ``slab.bitflip``,
``slab.stale`` and ``retire.plausible`` fault points inject what each
catches.

Only the injected launch faults and a device out-of-memory count as launch
failures.  A kernel that fails to build or launch (``KernelError``), and
an asynchronous device error surfacing at the logits fetch, propagate out
of :meth:`CnnEngine.step`: retrying cannot mend them, and degrading would
serve the ``direct`` route's library convolutions under the ``pallas``
route's name.  On the card, ``use_pallas`` or ``fc_bfp`` builds the
kernels when the engine is made.  The ``direct``-route twin a degraded
bucket falls back to keeps ``fc_bfp`` and ``conv_bfp``: its FC layers still
run the BFP matmul kernel, and its convolutions quantized raw filters.

Data parallelism: with ``data_parallel`` one engine drives the devices of
a 1-axis ("data",) mesh (``parallel.sharding.data_parallel_mesh``: every
visible card, or the ``devices`` given), as the reference's one program
does: a replica of the params (and of the BFP FC streams) on each device,
and each bucket's slabs packed on each for the rows it runs.  A bucket
whose batch divides by the device count is split over them, each share
copied from the pinned buffer straight to its device; any other runs
whole on the first device (the reference's ``replicated_sharding``
fallback).  The logits (and the ABFT verdicts, summed) are gathered on the
first device.  The slab chaos points act on the first device's slabs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import build
from ..kernels.conv.dma import WeightStager
from ..models import model_for
from ..nn.conv import verify_packed
from ..nn.module import tree_map
from ..parallel.sharding import data_parallel_mesh
from .clock import MONOTONIC, Clock
from .faults import EngineCrash, FaultInjector, TransientLaunchError
from .health import QUARANTINED, HealthMonitor
from .policy import AdmissionController, DynamicBucketPolicy, bucket_sizes
from .scheduler import DrainTimeout, LatencyTracker, SlotScheduler

__all__ = ["CnnEngine", "CnnServeConfig", "ImageRequest", "bucket_sizes"]

# launch failures the retry/degrade ladder handles; everything else raised
# by a forward propagates
_TRANSIENT_LAUNCH = (TransientLaunchError, torch.cuda.OutOfMemoryError)


@dataclass
class CnnServeConfig:
    max_batch: int = 8          # largest serve bucket (paper's S_batch knob)
    staging_depth: int = 2      # groups staged ahead of compute
    data_parallel: bool = False  # split buckets over the data mesh's devices
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
    verify_slabs: bool = False      # pre-dispatch slab fingerprint check
    screen_abs_max: Optional[float] = None  # |logit| bound on the screen
    # -- tuned launch plans (core/autotune.py) ----------------------------
    plan_cache: Optional[str] = None  # None: results/plans/alexnet_torch.json


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
    images: object              # per device used: its rows (r, H, W, C)
    host: object = None         # pinned source of an in-flight H2D copy
    logits: object = None       # device tensor once the forward is issued
    sdc: object = None          # device int32 ABFT verdict (sdc_abft only)
    t_launch: float = 0.0
    first_compile: bool = False  # first launch of this bucket shape


class CnnEngine:
    """Serves ``cfg`` on ``device`` (the card unless told otherwise); under
    ``scfg.data_parallel`` on the data mesh of ``devices`` (default: every
    visible card, or ``device`` itself when it is not a card), the first
    of them holding ``params``."""

    def __init__(self, cfg, scfg: CnnServeConfig, *, params=None,
                 seed: int = 0, faults: Optional[FaultInjector] = None,
                 clock: Optional[Clock] = None, device="cuda",
                 devices=None):
        if devices is not None and not scfg.data_parallel:
            raise ValueError("CnnEngine(devices=) needs data_parallel")
        self.devices = (torch.device(device),)
        if scfg.data_parallel:
            if devices is None and torch.device(device).type != "cuda":
                devices = (device,)
            self.devices = data_parallel_mesh(devices)
        self.device = resolve_device(self.devices[0])
        if (cfg.use_pallas or cfg.fc_bfp) and self.device.type == "cuda":
            build.library()     # a kernel that cannot build fails here
        self.cfg, self.scfg = cfg, scfg
        self.clock = clock or MONOTONIC
        self.mod = model_for(cfg)
        if params is None:
            params = self.mod.init(seed, cfg, device=self.device)
        self.params = params
        # a replica of the params on each further device of the data mesh
        self._replicas = [params] + [
            tree_map(lambda t, d=d: t.to(resolve_device(d)), params)
            for d in self.devices[1:]]
        self._buckets = bucket_sizes(scfg.max_batch)
        self._buf_dtype = self.mod.DTYPES[cfg.dtype]
        self.sched = SlotScheduler(scfg.max_batch * scfg.staging_depth)
        self.arm_slo(scfg.slo_ms, dynamic_buckets=scfg.dynamic_buckets,
                     admission=scfg.admission)

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

        # tuned launch plans from the measured autotuner's cache, keyed to
        # this config's layers and this card
        self.plans: Dict[str, object] = self.mod.load_tuned_plans(
            cfg, scfg.max_batch, path=scfg.plan_cache, device=self.device)
        # per device of the data mesh: bucket -> its packed slabs
        self._slab_caches: List[Dict[int, dict]] = [
            {} for _ in self.devices]
        self._slab_caches_direct: List[Dict[int, dict]] = [
            {} for _ in self.devices]
        self._packed = self._slab_caches[0]      # the first device's
        # batch-independent staging (the BFP FC streams), shared by every
        # bucket and by the degrade twin, one a device
        self._stagers = [WeightStager() for _ in self.devices]
        self._launched: set = set()
        self._launched_direct: set = set()
        self._abft = bool(cfg.sdc_abft)
        self.sdc_detections = 0
        self.slab_integrity_failures = 0
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

    def arm_slo(self, slo_ms: Optional[float], *,
                dynamic_buckets: bool = False, admission: bool = False):
        """Arm (or replace, or with ``slo_ms=None`` remove) the SLO control
        plane on a live engine: a deployment sets its SLO from service
        times measured on a warm engine.  Only the policy objects are
        rebuilt; the packed slabs of every bucket and the counters stay."""
        scfg = dataclasses.replace(self.scfg, slo_ms=slo_ms,
                                   dynamic_buckets=dynamic_buckets,
                                   admission=admission)
        self.scfg = scfg
        self.policy = (DynamicBucketPolicy(
            scfg.max_batch, scfg.slo_ms, max_extra=scfg.max_extra_buckets,
            window=scfg.policy_window)
            if scfg.slo_ms and scfg.dynamic_buckets else None)
        self.admission = (AdmissionController(
            scfg.slo_ms, slack=scfg.admission_slack)
            if scfg.slo_ms and scfg.admission else None)

    def arm_faults(self, injector: Optional[FaultInjector]):
        """Attach (or detach) a fault injector on a live engine: chaos runs
        arm after the warm-up, so the points' opportunities count serving
        launches."""
        self.faults = injector

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

    def _split(self, bucket: int) -> int:
        """The devices a bucket runs on: all of the data mesh's when its
        batch divides by their count, else the first alone."""
        n = len(self.devices)
        return n if bucket % n == 0 else 1

    def _put(self, src: torch.Tensor):
        """(per-device tensors, pinned source): each device's rows of the
        bucket ``src``, async H2D copies from a pinned buffer on the card;
        the source must live until the copies are done."""
        k = self._split(src.shape[0])
        if self.device.type != "cuda":
            return [p.to(d) for p, d in zip(src.chunk(k), self.devices)], \
                None
        src = src.pin_memory()
        return [p.to(d, non_blocking=True)
                for p, d in zip(src.chunk(k), self.devices)], src

    def _slabs(self, bucket: int, dev: int = 0):
        """Pack-once weight slabs for one bucket shape, on device ``dev``
        of the data mesh, for the rows it runs."""
        cache = self._slab_caches[dev]
        if bucket not in cache:
            cache[bucket] = self.mod.pack_serving_slabs(
                self._replicas[dev], self.cfg, bucket // self._split(bucket),
                plans=self.plans, fingerprint=self.scfg.verify_slabs,
                stager=self._stagers[dev])
        return cache[bucket]

    def _slabs_direct(self, bucket: int, dev: int = 0):
        cache = self._slab_caches_direct[dev]
        if bucket not in cache:
            cache[bucket] = self.mod.pack_serving_slabs(
                self._replicas[dev], self._cfg_direct,
                bucket // self._split(bucket), stager=self._stagers[dev])
        return cache[bucket]

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

    # -- SDC defense internals -----------------------------------------
    @staticmethod
    def _slab_entries(packed: dict) -> List[str]:
        """Names of the packed conv slabs (a tensor behind a
        ``PackedConvWeights``), sorted, so payload draws index them as the
        reference does."""
        return sorted(k for k, v in packed.items()
                      if hasattr(v, "kernel")
                      and getattr(v, "data", None) is not None)

    def _inject_bitflip(self, bucket: int):
        """``slab.bitflip`` payload: flip one bit of the bucket's staged
        slabs (the first device's) — layer, byte and bit drawn from the
        point's payload stream in that order, as the reference draws them
        — in a copy on the device, which replaces the cache entry.  The
        params stay pristine, so the repack after detection restores a
        clean slab."""
        packed = self._slabs(bucket)
        names = self._slab_entries(packed)
        if not names:
            return
        rng = self.faults.payload_rng("slab.bitflip")
        name = names[int(rng.integers(len(names)))]
        pw = packed[name]
        data = pw.data.clone()
        flat = data.view(-1).view(torch.uint8)
        byte = int(rng.integers(flat.numel()))
        flat[byte] ^= 1 << int(rng.integers(8))
        self._packed[bucket] = {
            **packed, name: dataclasses.replace(pw, data=data)}

    def _inject_stale(self, bucket: int):
        """``slab.stale`` payload: one layer's cache entry starts serving
        another layer's slab (its own fingerprint stays, so only the
        fingerprint check can tell)."""
        packed = self._slabs(bucket)
        names = self._slab_entries(packed)
        if len(names) < 2:
            return
        rng = self.faults.payload_rng("slab.stale")
        i = int(rng.integers(len(names)))
        victim, donor = names[i], names[(i + 1) % len(names)]
        self._packed[bucket] = {
            **packed, victim: dataclasses.replace(
                packed[victim], data=packed[donor].data)}

    def _slabs_intact(self, bucket: int, degraded: bool) -> bool:
        """Pre-dispatch fingerprint check of the bucket's staged slabs on
        every device (a host copy of each); unfingerprinted entries
        pass."""
        caches = self._slab_caches_direct if degraded else self._slab_caches
        return all(verify_packed(v) for cache in caches
                   for v in cache.get(bucket, {}).values()
                   if hasattr(v, "kernel"))

    def _fail_batch(self, g: _Group, kind: str, *, repack: bool = False):
        """A datapath failure: count it, feed health and the degradation
        ladder, optionally drop the bucket's staged slabs (the retry
        repacks from the pristine params), re-queue the group."""
        self.batches_failed += 1
        self.health.record_failure(kind)
        self._note_datapath_failure(g.bucket, kind)
        if repack:
            for cache in self._slab_caches + self._slab_caches_direct:
                cache.pop(g.bucket, None)
        self._requeue_group(g)

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
            # the model's dtype (a bf16 image rounds to nearest even here,
            # as the forward's own cast would)
            buf = torch.zeros((bucket, h, w, c), dtype=self._buf_dtype)
            for i, r in enumerate(reqs):
                buf[i] = torch.from_numpy(np.asarray(r.image, np.float32))
            if self.faults is not None and self.faults.fire("stage.corrupt"):
                buf[0] = float("nan")   # the staged copy only
            images, host = self._put(buf)
            self._staged.append(_Group(slots, reqs, bucket, images, host))

    @torch.no_grad()
    def _forward(self, g: _Group, degraded: bool):
        """The logits of the group's rows (with the ABFT verdict under
        ``sdc_abft``) on the first device: each device used runs its rows
        (its kernels launched with it current).  No autograd graph."""
        outs = []
        for dev, x in enumerate(g.images):
            d = self.devices[dev]
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()):
                if degraded:
                    outs.append(self.mod.apply(
                        self._replicas[dev], self._cfg_direct, x,
                        packed=self._slabs_direct(g.bucket, dev)))
                else:
                    outs.append(self.mod.apply(
                        self._replicas[dev], self.cfg, x, plans=self.plans,
                        packed=self._slabs(g.bucket, dev)))
        if len(outs) == 1:
            return outs[0]
        if self._abft:
            return (torch.cat([o.to(self.device) for o, _ in outs]),
                    sum(v.to(self.device) for _, v in outs))
        return torch.cat([o.to(self.device) for o in outs])

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
        # slab chaos on the primary route's staged slabs, then the
        # pre-dispatch fingerprint gate: a corrupted or stale slab never
        # reaches a forward
        if self.faults is not None and not degraded:
            if self.faults.fire("slab.bitflip"):
                self._inject_bitflip(g.bucket)
            if self.faults.fire("slab.stale"):
                self._inject_stale(g.bucket)
        if (self.scfg.verify_slabs
                and not self._slabs_intact(g.bucket, degraded)):
            self.slab_integrity_failures += 1
            self._fail_batch(g, "slab", repack=True)
            return
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
            if self._abft:
                g.logits, g.sdc = g.logits
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
        # (bf16 logits cross to the host as float32, exactly)
        logits = g.logits.float().cpu().numpy()[: len(g.reqs)]
        g.host = None
        # the ABFT verdict, read after the logits' copy (its kernels ran
        # before the FC layers, so this adds no wait): a positive count
        # taints the whole batch, which is never served; the retry repacks
        # the bucket's slabs from the pristine params
        if g.sdc is not None and int(g.sdc) > 0:
            self.sdc_detections += 1
            self._fail_batch(g, "sdc", repack=True)
            return
        if self.faults is not None:
            spec = self.faults.fire("retire.latency")
            if spec is not None and spec.delay_ms:
                self.clock.sleep(spec.delay_ms / 1e3)
            if self.faults.fire("retire.nonfinite"):
                logits = np.array(logits)
                logits[0] = np.nan
            spec = self.faults.fire("retire.plausible")
            if spec is not None:
                # finite corruption that passes the isfinite screen; only
                # screen_abs_max catches it
                logits = np.array(logits)
                rng = self.faults.payload_rng("retire.plausible")
                row = int(rng.integers(len(logits)))
                logits[row] = logits[row] + (spec.magnitude or 1e8)
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
        self.sdc_detections = 0
        self.slab_integrity_failures = 0
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
            "sdc": {
                "abft_armed": self._abft,
                "verify_slabs": self.scfg.verify_slabs,
                "detections": self.sdc_detections,
                "slab_integrity_failures": self.slab_integrity_failures,
                "screen_nonfinite": self.screen_nonfinite,
                "screen_magnitude": self.screen_magnitude,
            },
            "accounting": self.accounting(),
        }
