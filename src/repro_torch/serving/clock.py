"""Injectable time source for the serving stack.

Every latency-bearing decision in the serving tier — retry backoff,
deadline expiry, circuit-breaker cooldown, injected latency spikes — used
to read ``time.perf_counter()`` / ``time.sleep()`` directly, which made
the corresponding tests wall-clock-bound (real sleeps) and chaos replays
only *statistically* reproducible (a loaded CI runner shifts which
deadline fires first).  A :class:`Clock` is threaded through
:class:`~repro_torch.serving.cnn.CnnEngine` and
:class:`~repro_torch.serving.health.HealthMonitor` instead:

* :class:`MonotonicClock` — the production default; delegates to
  ``time.perf_counter`` / ``time.sleep``.  The module-level
  :data:`MONOTONIC` singleton is what every engine uses when no clock is
  passed, so the default path allocates nothing new.
* :class:`VirtualClock` — a manually advanced clock for tests and
  deterministic chaos replays: ``now()`` returns the virtual time,
  ``sleep()`` *advances* it instead of blocking, and ``advance()`` moves
  time forward explicitly.  Cooldown/deadline/backoff tests become exact
  and sleep-free: "wait out the 250 ms cooldown" is ``clock.advance(0.25)``.

The clock contract is monotone seconds (perf_counter semantics), not wall
time — nothing in serving needs calendar time.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "MonotonicClock", "VirtualClock", "MONOTONIC"]


class Clock:
    """Time-source protocol: monotone ``now()`` seconds + ``sleep()``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real time: ``time.perf_counter`` / ``time.sleep``."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Manually advanced clock — deterministic, sleep-free tests.

    ``sleep`` advances virtual time (a component that sleeps still
    observes time passing), so engine code behaves identically under
    either clock; only the wall stops moving.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        assert seconds >= 0, f"clock cannot run backwards ({seconds})"
        self._t += seconds
        return self._t


MONOTONIC = MonotonicClock()
