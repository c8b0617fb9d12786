"""Workload-agnostic slot-scheduler core shared by the serving engines.

Both serving regimes in the paper reduce to the same bookkeeping: a fixed
pool of batch slots that admitted requests occupy while the accelerator
works, fed FIFO from a submission queue.  The token-decode :class:`Engine`
holds a slot for the lifetime of a request (its cache row lives there across
many decode ticks); the image :class:`CnnEngine` holds slots only for the
duration of one bucketed forward pass.  The scheduler owns slots, queue and
admission/retirement counters; the engines own all device state.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


class DrainTimeout(RuntimeError):
    """``run_until_done`` exhausted its step budget with work still in
    flight.  Carries a ``report`` dict (queued/staged/computing/retrying
    counts per engine) so a hung fleet fails loudly with its state instead
    of silently vanishing the in-flight requests."""

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


class SlotScheduler:
    """Fixed slot pool + FIFO admission queue (no device state)."""

    def __init__(self, n_slots: int):
        assert n_slots > 0, n_slots
        self.n_slots = n_slots
        self.slot_req: List[Optional[object]] = [None] * n_slots
        # deque, not list: admission drains the queue head one request at a
        # time, and a deep backlog (the fleet traffic generator routinely
        # queues thousands) would make list.pop(0) O(n^2) overall.
        self.queue: Deque[object] = deque()
        self.submitted = 0
        self.completed = 0

    # -- queue --------------------------------------------------------------
    def submit(self, req) -> None:
        self.queue.append(req)
        self.submitted += 1

    def requeue(self, reqs) -> None:
        """Return previously admitted requests to the *front* of the queue
        (retry path: they keep their FIFO seniority) without re-counting
        them as submitted — each request is submitted exactly once."""
        self.queue.extendleft(reversed(list(reqs)))

    # -- slots --------------------------------------------------------------
    @property
    def active(self) -> np.ndarray:
        """Boolean occupancy mask, index-aligned with the slot pool."""
        return np.asarray([r is not None for r in self.slot_req], bool)

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def idle(self) -> bool:
        return not self.queue and self.occupancy == 0

    def occupied(self) -> List[Tuple[int, object]]:
        """Snapshot of (slot, request) pairs — safe to retire while iterating."""
        return [(i, r) for i, r in enumerate(self.slot_req) if r is not None]

    def admit(self, limit: Optional[int] = None) -> List[Tuple[int, object]]:
        """Move queued requests into free slots (FIFO, lowest slot first)."""
        out: List[Tuple[int, object]] = []
        for slot in range(self.n_slots):
            if not self.queue or (limit is not None and len(out) >= limit):
                break
            if self.slot_req[slot] is not None:
                continue
            req = self.queue.popleft()
            self.slot_req[slot] = req
            out.append((slot, req))
        return out

    def retire(self, slot: int):
        req = self.slot_req[slot]
        assert req is not None, f"retire of empty slot {slot}"
        self.slot_req[slot] = None
        self.completed += 1
        return req

    def release(self, slot: int):
        """Free a slot *without* counting a completion — the retry/expiry
        path: the request either re-queues or retires as expired, and the
        completed counter must only ever count served results."""
        req = self.slot_req[slot]
        assert req is not None, f"release of empty slot {slot}"
        self.slot_req[slot] = None
        return req


class LatencyTracker:
    """Submit->complete request latency percentiles (Tables 5-6 companion:
    the paper reports throughput; a serving system must also bound tail
    latency, which batching trades against).

    Bounded: samples live in a sliding window (``deque(maxlen=window)``) so
    a long-running fleet neither leaks memory nor pays an ever-growing
    ``np.percentile`` — and the reported p50/p90/p99 track *recent* traffic,
    which is what an SLO controller needs to react to.  ``total`` counts
    every recorded sample for throughput accounting.
    """

    def __init__(self, window: int = 4096):
        assert window >= 1, window
        self.window = window
        self._lat_s: Deque[float] = deque(maxlen=window)
        self.total = 0

    def record(self, seconds: float) -> None:
        self._lat_s.append(seconds)
        self.total += 1

    def __len__(self) -> int:
        return len(self._lat_s)

    def percentiles_ms(self, qs=(50, 90, 99)) -> dict:
        if not self._lat_s:
            return {f"p{q}": 0.0 for q in qs}
        a = np.asarray(self._lat_s)
        return {f"p{q}": float(np.percentile(a, q)) * 1e3 for q in qs}
