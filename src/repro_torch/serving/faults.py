"""Deterministic, seeded fault injection for the serving stack.

The paper's 1020 img/s (§4) is measured on an uninterrupted pipeline; a
production fleet must keep its accounting and SLO story intact when a
launch throws, a logit goes non-finite, or a device stalls (the gap the
FPGA-accelerator surveys flag between benchmark and deployed systems).
:class:`FaultInjector` makes those failures *reproducible*: every fault
point is a named hook the engine calls at a pipeline stage, each point
counts its own opportunities, and firing decisions come from a per-point
seeded RNG stream (or an explicit opportunity-index schedule), so a chaos
run replays bit-identically from (seed, schedule) regardless of how other
points interleave.

Fault points (wired through ``CnnEngine._stage/_launch/_finish_oldest``):

==================  ======================================================
``stage.corrupt``   staging-buffer corruption: NaNs written into the host
                    staging buffer *after* the request images are copied
                    in (the pristine ``req.image`` survives for retry) —
                    caught downstream by the retire-time finiteness screen
``launch.transient``transient launch failure (RESOURCE_EXHAUSTED class):
                    the forward dispatch raises
                    :class:`TransientLaunchError`; the engine re-queues
                    the group with exponential backoff
``launch.crash``    hard engine crash: raises :class:`EngineCrash`; the
                    health monitor force-quarantines the engine (circuit
                    opens, cooldown, half-open probe)
``retire.nonfinite``NaN written into fetched logits before the screen —
                    models device-side numeric corruption; affected
                    requests are retried, never served the bad row
``retire.latency``  host-side latency spike (``delay_ms`` sleep) during
                    retirement — exercises deadline expiry and SLO
                    accounting without corrupting data
``worker.crash``    process-level chaos (fired by the *supervisor*, one
                    injector per worker): SIGKILL the worker process at
                    this pump opportunity — exercises heartbeat death
                    detection, failover re-dispatch, and crash-consistent
                    restart (``serving/supervisor.py``)
``worker.stall``    process-level chaos: the worker's command loop sleeps
                    ``delay_ms`` before replying, so the supervisor's
                    heartbeat deadline trips — exercises the liveness
                    ladder without killing the process
``slab.bitflip``    silent data corruption: one bit flipped in a staged
                    weight slab before dispatch (position drawn from the
                    point's payload RNG stream) — the SEU/DRAM-corruption
                    model ABFT exists for; caught by the in-kernel
                    checksum verdict and/or the slab fingerprint check
``slab.stale``      staging-path confusion: a *different layer's* slab is
                    served from the cache at dispatch — models the silent
                    stale-reuse bug class; caught by fingerprint context
                    verification (``CnnServeConfig.verify_slabs``)
``retire.plausible``bounded-magnitude logit perturbation (``magnitude``
                    added to one row) — *finite* corruption that defeats
                    the isfinite screen; caught only by the magnitude
                    bound (``CnnServeConfig.screen_abs_max``)
==================  ======================================================

Arming is zero-overhead when idle: the engine guards every hook with
``self.faults is not None``, and an armed injector with no matching spec
only bumps an integer opportunity counter — it never touches the data
path or draws from an RNG, so an armed-but-idle run is bit-identical to a
no-injector run (the CI chaos-smoke gate asserts exactly this).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["FAULT_POINTS", "FaultSpec", "FaultInjector",
           "TransientLaunchError", "EngineCrash", "derive_seed"]

# order matters: each point's RNG stream is keyed by its index, so new
# points append (existing committed chaos schedules stay bit-reproducible)
FAULT_POINTS = ("stage.corrupt", "launch.transient", "launch.crash",
                "retire.nonfinite", "retire.latency",
                "worker.crash", "worker.stall",
                "slab.bitflip", "slab.stale", "retire.plausible")


class TransientLaunchError(RuntimeError):
    """A retryable launch failure (the RESOURCE_EXHAUSTED class: transient
    allocator pressure, queue-full, preemption).  The engine re-queues the
    group with backoff instead of crashing."""
    code = "RESOURCE_EXHAUSTED"


class EngineCrash(RuntimeError):
    """A hard, non-retryable engine failure.  The health monitor
    force-quarantines the engine; the registry stops admitting to it."""
    code = "ENGINE_CRASH"


@dataclass(frozen=True)
class FaultSpec:
    """When (and how) one fault point fires.

    ``rate``      per-opportunity firing probability, drawn from the
                  point's own seeded RNG stream.
    ``at``        explicit opportunity indices that always fire (0-based,
                  counted per point since arming) — exact schedules for
                  tests and committed chaos runs.
    ``limit``     cap on total firings (None = unbounded).
    ``delay_ms``  payload for ``retire.latency`` (spike duration).
    ``magnitude`` payload for ``retire.plausible`` (the finite offset
                  added to one logit row; 0.0 = the point's default).
    """
    rate: float = 0.0
    at: Tuple[int, ...] = ()
    limit: Optional[int] = None
    delay_ms: float = 0.0
    magnitude: float = 0.0

    def __post_init__(self):
        assert 0.0 <= self.rate <= 1.0, self.rate
        assert self.limit is None or self.limit >= 0, self.limit


def derive_seed(seed: int, name: str) -> int:
    """Stable per-engine seed derivation so a fleet-level chaos seed fans
    out into independent, reproducible per-engine streams."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (2 ** 31)


@dataclass
class FaultEvent:
    point: str
    opportunity: int                # per-point opportunity index that fired


class FaultInjector:
    """Seeded, named-point chaos source.  One injector per engine — each
    point owns an independent RNG stream (``default_rng([seed, point_i])``)
    and an opportunity counter, so the firing pattern is a pure function
    of (seed, specs) and the engine's own call sequence."""

    def __init__(self, seed: int = 0,
                 specs: Optional[Dict[str, FaultSpec]] = None):
        specs = dict(specs or {})
        unknown = set(specs) - set(FAULT_POINTS)
        if unknown:
            raise ValueError(f"unknown fault points {sorted(unknown)}; "
                             f"valid: {list(FAULT_POINTS)}")
        self.seed = seed
        self.specs = specs
        self._rng = {p: np.random.default_rng([seed, i])
                     for i, p in enumerate(FAULT_POINTS)}
        self._seen: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self._fired: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self.events: List[FaultEvent] = []

    def fire(self, point: str) -> Optional[FaultSpec]:
        """Record one opportunity at ``point``; return the spec iff the
        fault fires now.  No spec for the point -> counter bump only (no
        RNG draw, no perturbation of other points' streams)."""
        assert point in FAULT_POINTS, point
        i = self._seen[point]
        self._seen[point] = i + 1
        spec = self.specs.get(point)
        if spec is None:
            return None
        if spec.limit is not None and self._fired[point] >= spec.limit:
            return None
        hit = i in spec.at
        if not hit and spec.rate:
            hit = bool(self._rng[point].random() < spec.rate)
        if not hit:
            return None
        self._fired[point] += 1
        self.events.append(FaultEvent(point, i))
        return spec

    def payload_rng(self, point: str) -> np.random.Generator:
        """The point's own RNG stream, for fault *payloads* (which bit to
        flip, which row to perturb) — drawn from the same per-point stream
        as the firing decisions, so payload positions replay from (seed,
        specs) too.  Only call after :meth:`fire` returned a spec (a
        payload draw advances the stream)."""
        assert point in FAULT_POINTS, point
        return self._rng[point]

    @property
    def total_fired(self) -> int:
        return sum(self._fired.values())

    def summary(self) -> dict:
        """Per-point (opportunities, fired) — persisted next to chaos
        results so a replay can be checked against the original run."""
        return {p: {"opportunities": self._seen[p], "fired": self._fired[p]}
                for p in FAULT_POINTS
                if self._seen[p] or p in self.specs}
