"""Per-engine health monitor + circuit breaker for the serving fleet.

PipeCNN's pipelined kernel chain shows how one stalled stage poisons
whole-pipeline throughput; the fleet analogue is one sick engine eating
the shared device queue while serving garbage.  :class:`HealthMonitor`
tracks consecutive datapath failures (launch exceptions, non-finite
retired logits) and walks a three-state machine:

    healthy --fail_threshold--> degraded --quarantine_threshold--> quarantined

* **healthy** — normal serving; any clean retirement resets the
  consecutive-failure count.
* **degraded** — elevated failures: the engine keeps serving (this is the
  warning state the route-degradation ladder reacts to), but one more run
  of failures quarantines it.
* **quarantined** — the circuit is open: ``allow_launch`` refuses
  dispatch, the registry stops admitting requests, queued work drains via
  deadline expiry.  After ``cooldown_ms`` the breaker goes *half-open*:
  exactly one probe launch is allowed through; a clean retirement closes
  the circuit (back to healthy), a failure re-arms the cooldown.

A hard crash (:class:`~repro_torch.serving.faults.EngineCrash`) skips the
ladder via :meth:`force_quarantine`.  All transitions are recorded in
``events`` for the fleet stats/chaos artifact.

Distinct from the *route* degradation ladder in ``serving/cnn.py``
(pallas -> direct per bucket): health states describe whether the engine
may launch at all; route degradation swaps the datapath a bucket launches
on.  Both are reported in ``stats()``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .clock import MONOTONIC, Clock

__all__ = ["HEALTHY", "DEGRADED", "QUARANTINED", "HealthMonitor"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"


class HealthMonitor:
    def __init__(self, *, fail_threshold: int = 3,
                 quarantine_threshold: int = 6,
                 cooldown_ms: float = 250.0,
                 clock: Optional[Clock] = None):
        assert 1 <= fail_threshold <= quarantine_threshold
        assert cooldown_ms >= 0
        self.clock = clock or MONOTONIC
        self.fail_threshold = fail_threshold
        self.quarantine_threshold = quarantine_threshold
        self.cooldown_ms = cooldown_ms
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.failures_total = 0
        self.ok_total = 0
        self.events: List[Tuple[str, str, str]] = []   # (from, to, reason)
        self._t_quarantined: Optional[float] = None
        self._probe_inflight = False

    # -- transitions --------------------------------------------------------
    def _move(self, to: str, reason: str):
        if to != self.state:
            self.events.append((self.state, to, reason))
            self.state = to

    def record_ok(self):
        """A clean batch retirement: closes a half-open circuit, clears
        the consecutive-failure count, recovers degraded -> healthy."""
        self.ok_total += 1
        self.consecutive_failures = 0
        if self.state == QUARANTINED and self._probe_inflight:
            self._probe_inflight = False
            self._t_quarantined = None
            self._move(HEALTHY, "probe-ok")
        elif self.state == DEGRADED:
            self._move(HEALTHY, "recovered")

    def record_failure(self, kind: str = "failure"):
        """A datapath failure (launch exception / non-finite logits)."""
        self.failures_total += 1
        self.consecutive_failures += 1
        if self.state == QUARANTINED:
            if self._probe_inflight:            # half-open probe failed
                self._probe_inflight = False
                self._t_quarantined = self.clock.now()
                self.events.append((QUARANTINED, QUARANTINED,
                                    f"probe-failed:{kind}"))
            return
        if self.consecutive_failures >= self.quarantine_threshold:
            self._t_quarantined = self.clock.now()
            self._probe_inflight = False
            self._move(QUARANTINED, f"{kind} x{self.consecutive_failures}")
        elif self.consecutive_failures >= self.fail_threshold:
            self._move(DEGRADED, f"{kind} x{self.consecutive_failures}")

    def force_quarantine(self, reason: str = "crash"):
        """Immediate circuit-open (hard crash path) — no ladder."""
        self.consecutive_failures = max(self.consecutive_failures,
                                        self.quarantine_threshold)
        self._t_quarantined = self.clock.now()
        self._probe_inflight = False
        self._move(QUARANTINED, reason)

    # -- gate ---------------------------------------------------------------
    def allow_launch(self, now: Optional[float] = None) -> bool:
        """May the engine dispatch a forward right now?  Healthy/degraded:
        yes.  Quarantined: only a single half-open probe once the cooldown
        has elapsed (the probe stays "in flight" until a record_ok /
        record_failure resolves it)."""
        if self.state != QUARANTINED:
            return True
        if self._probe_inflight:
            return False
        now = self.clock.now() if now is None else now
        if (self._t_quarantined is not None
                and (now - self._t_quarantined) * 1e3 >= self.cooldown_ms):
            self._probe_inflight = True         # half-open: one probe
            return True
        return False

    def cancel_probe(self):
        """Release a half-open probe that found nothing admissible to
        launch, so a later ``allow_launch`` may probe again."""
        self._probe_inflight = False

    def stats(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "failures_total": self.failures_total,
            "ok_total": self.ok_total,
            "events": [{"from": a, "to": b, "reason": r}
                       for a, b, r in self.events],
        }
