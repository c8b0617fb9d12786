"""SLO control plane for the CNN serving engines: dynamic occupancy
buckets + admission control.

The paper's §3.7 batching picks one S_batch ahead of time; a production
fleet faces a latency SLO under time-varying traffic, where the fixed
power-of-two ladder has two failure modes this module addresses:

* **Padding waste under bursty arrivals** — a burst of, say, 6 requests is
  padded to the 8-bucket forever, so every batch carries 25% dead compute
  and the backlog drains that much slower.  :class:`DynamicBucketPolicy`
  watches the recent admitted group sizes whenever the windowed p99 is
  over the SLO and *inserts a bucket at the dominant group size* — the
  ladder resizes to the traffic.  Extra buckets are bounded
  (``max_extra``), so the §3.7 bounded-recompile guarantee survives: at
  most ``O(log2 max_batch) + max_extra`` batch shapes ever compile.

* **Unbounded queueing past the SLO** — once the arrival rate exceeds the
  service rate, every queued request is already late and admitting more
  only pushes the tail further out.  :class:`AdmissionController` tracks
  an EWMA of the per-image service time and sheds a request when the
  estimated queue drain time at admission already exceeds the SLO budget
  (classic load shedding: protect the goodput of the requests that can
  still make their deadline).

Both are pure host-side bookkeeping — no device state — so they compose
with any engine that reports admitted group sizes and completion
latencies.  The fleet benchmark (``benchmarks/serve_fleet.py``) measures
the p99 deltas both levers buy on bursty/diurnal traces.
"""
from __future__ import annotations

from collections import Counter, deque
from typing import Deque, List, Optional, Tuple

from .scheduler import LatencyTracker


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two below ``max_batch`` plus ``max_batch`` itself — the
    base §3.7 ladder every policy starts from."""
    assert max_batch >= 1, max_batch
    bs: List[int] = []
    b = 1
    while b < max_batch:
        bs.append(b)
        b *= 2
    bs.append(max_batch)
    return tuple(bs)


class DynamicBucketPolicy:
    """Resize the bucket ladder under a p99-latency SLO.

    Observes admitted group sizes and completion latencies over a sliding
    window; while the windowed p99 exceeds ``slo_ms`` it looks for the
    dominant group size whose current bucket pads by at least
    ``pad_frac`` and inserts that size as a new bucket (at most
    ``max_extra`` insertions, so jit compiles stay bounded).  Inserted
    buckets only ever *shrink* padding — group->bucket mapping stays
    next-bucket-up — so outputs are unchanged by construction; only the
    padded dead compute per batch drops.
    """

    def __init__(self, max_batch: int, slo_ms: float, *, max_extra: int = 2,
                 window: int = 64, min_samples: int = 16,
                 pad_frac: float = 0.2):
        assert slo_ms > 0 and max_extra >= 0
        self.max_batch = max_batch
        self.slo_ms = slo_ms
        self.max_extra = max_extra
        self.min_samples = min_samples
        self.pad_frac = pad_frac
        self.base = bucket_sizes(max_batch)
        self.extra: List[int] = []
        self.resizes: List[int] = []        # insertion log (stats/debug)
        self._admits: Deque[int] = deque(maxlen=window)
        self._lat = LatencyTracker(window=window)

    def buckets(self) -> Tuple[int, ...]:
        """The current ladder (base + inserted sizes, ascending)."""
        return tuple(sorted(set(self.base) | set(self.extra)))

    def observe_admit(self, group_size: int) -> None:
        self._admits.append(group_size)

    def observe_latency(self, seconds: float) -> None:
        self._lat.record(seconds)

    def p99_ms(self) -> float:
        return self._lat.percentiles_ms((99,))["p99"]

    def maybe_resize(self) -> Optional[int]:
        """Insert one bucket if the SLO is busted and padding waste is the
        dominant pattern; returns the inserted size (or None)."""
        if len(self.extra) >= self.max_extra:
            return None
        if len(self._lat) < self.min_samples or not self._admits:
            return None
        if self.p99_ms() <= self.slo_ms:
            return None
        ladder = self.buckets()
        counts = Counter(self._admits)
        for n, c in counts.most_common():
            if c < max(len(self._admits) // 4, 2):
                break                       # no dominant group size
            b = next(x for x in ladder if x >= n)
            if b > n and (b - n) / b >= self.pad_frac:
                self.extra.append(n)
                self.resizes.append(n)
                self._admits.clear()        # re-observe under the new ladder
                return n
        return None


class AdmissionController:
    """Shed requests the SLO can no longer absorb (load shedding).

    ``observe_batch(n_images, seconds)`` feeds an EWMA of the per-image
    service time from every retired batch; ``admit(backlog_images)``
    estimates the newcomer's queue drain time as ``backlog * t_img`` and
    rejects when that estimate already exceeds ``slo_ms * slack`` — the
    request would bust its deadline just waiting, so completing it would
    only steal service from requests that can still make theirs.  Before
    the first observation every request is admitted (no estimate, no
    grounds to shed).
    """

    def __init__(self, slo_ms: float, *, slack: float = 1.0,
                 ewma: float = 0.2):
        assert slo_ms > 0 and slack > 0 and 0 < ewma <= 1
        self.slo_ms = slo_ms
        self.slack = slack
        self.ewma = ewma
        self.t_img_ms: Optional[float] = None

    def observe_batch(self, n_images: int, seconds: float) -> None:
        per_ms = seconds * 1e3 / max(n_images, 1)
        self.t_img_ms = (per_ms if self.t_img_ms is None else
                         (1 - self.ewma) * self.t_img_ms
                         + self.ewma * per_ms)

    def estimated_wait_ms(self, backlog_images: int) -> float:
        if self.t_img_ms is None:
            return 0.0
        return backlog_images * self.t_img_ms

    def admit(self, backlog_images: int,
              deadline_ms: Optional[float] = None) -> bool:
        """Admit unless the estimated queue wait already busts the budget.
        A request-level ``deadline_ms`` tightens the budget to
        ``min(slo * slack, deadline)``: a request that would expire just
        waiting is shed at the door (reported) instead of burning a slot
        and retiring as expired after wasting service time."""
        budget = self.slo_ms * self.slack
        if deadline_ms is not None:
            budget = min(budget, deadline_ms)
        return self.estimated_wait_ms(backlog_images) <= budget
