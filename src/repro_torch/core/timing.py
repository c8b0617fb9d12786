"""Measured timing shared by the autotuner and ``chip_smoke.py`` (the
reference's ``repro/core/timing.py``, with the card's device time in place
of the TPU's fenced wall time).

One discipline for every measured number:

* **warm-up** calls first: the first call pays the kernels' build, the
  allocator's first requests and the caches' warming, and never lands in a
  sample;
* on a CUDA device each sample is **device time**: CUDA events around one
  call, with the 50 MB L2 flushed before it by reading 64 MB (a serving
  forward finds every layer's weights evicted by the others; a read leaves
  clean lines, so the timed call does not pay for writing a flush buffer
  back) and a spin kernel queued ahead of the start event, which keeps
  the card busy while the host enqueues the call, so the events bracket
  the call's device work and not the Python that launches it;
* on the CPU each sample is ``perf_counter`` wall time of one call
  (CPU tensors compute synchronously, so nothing needs a fence);
* **median-of-k**, robust to one-sided noise (preemption, clock ramps);
* a **steady-state guard**: while the middle half of the samples spreads
  more than ``steady_rtol`` around the median, another round of samples is
  taken, up to ``max_rounds``, and the :class:`Timing` records whether the
  run settled.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

FLUSH_BYTES = 64 * 2 ** 20      # more than the H100's 50 MB L2
SPIN_MIN_S = 5e-3               # the spin ahead of a sample, at least
SPIN_CLOCK_HZ = 2e9             # cycles a second the spin is sized for
CUDA_WARMUP = 3                 # warm calls on the card, at least


@dataclass(frozen=True)
class Timing:
    """One measured call: median microseconds and the evidence behind it."""
    us: float                   # median time per call, microseconds
    samples: tuple              # all collected samples (us), sorted
    spread: float               # IQR / median of the final sample set
    steady: bool                # spread <= steady_rtol within max_rounds
    rounds: int                 # sample rounds taken (1 = no retry needed)

    def __float__(self) -> float:
        return self.us


def _iqr_spread(sorted_us) -> float:
    n = len(sorted_us)
    med = sorted_us[n // 2]
    if med <= 0:
        return 0.0
    q1, q3 = sorted_us[n // 4], sorted_us[(3 * n) // 4]
    return (q3 - q1) / med


def _device_of(args):
    """The CUDA device of the first CUDA tensor among ``args``, else None."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return None


class CudaSampler:
    """Device-time samples of ``fn(*args)`` on one CUDA device.

    Construction runs the warm-up: ``warmup`` calls (at least
    :data:`CUDA_WARMUP`), each fenced, whose enqueue times after the first
    size the spin: three times the slowest and at least
    :data:`SPIN_MIN_S`, at up to :data:`SPIN_CLOCK_HZ`, so a call the host
    is slow to enqueue cannot leave the card idle inside the events."""

    def __init__(self, fn, args=(), *, device="cuda",
                 warmup: int = CUDA_WARMUP):
        self.fn, self.args = fn, args
        self.device = torch.device(device)
        self.flush = torch.zeros(FLUSH_BYTES // 4, device=self.device)
        enqueue = []
        for _ in range(max(warmup, CUDA_WARMUP)):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            fn(*args)
            enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize(self.device)
        self.cycles = int(max(3 * max(enqueue[1:]), SPIN_MIN_S)
                          * SPIN_CLOCK_HZ)

    def sample(self) -> tuple[float, float]:
        """(device us, host us) of one call: the host's is the time the
        call takes to return, i.e. to enqueue its work."""
        with torch.cuda.device(self.device):
            self.flush.sum()
            torch.cuda._sleep(self.cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            self.fn(*self.args)
            host = time.perf_counter() - t0
            end.record()
            end.synchronize()
        return start.elapsed_time(end) * 1e3, host * 1e6


def measure(fn, *args, warmup: int = 1, iters: int = 3,
            steady_rtol: float = 0.25, max_rounds: int = 3, device=None,
            clock=time.perf_counter) -> Timing:
    """Measure ``fn(*args)``; returns a :class:`Timing` in microseconds.

    ``device``: where the call runs, by default the device of the first
    CUDA tensor among ``args`` (else the CPU).  On a CUDA device the
    samples are device time (:class:`CudaSampler`); on the CPU, ``clock``
    wall time around each call (a test injects durations through it).
    ``warmup`` calls run before any sample.  If the samples' inter-quartile
    spread exceeds ``steady_rtol`` of the median, another round of
    ``iters`` samples is collected (the median is then taken over all
    samples), at most ``max_rounds`` rounds."""
    device = torch.device(device) if device is not None else _device_of(args)
    if device is not None and device.type == "cuda":
        sample = CudaSampler(fn, args, device=device, warmup=warmup).sample

        def one() -> float:
            return sample()[0]
    else:
        for _ in range(max(warmup, 0)):
            fn(*args)

        def one() -> float:
            t0 = clock()
            fn(*args)
            return (clock() - t0) * 1e6
    samples: list[float] = []
    rounds = 0
    while True:
        rounds += 1
        samples.extend(one() for _ in range(max(iters, 1)))
        samples.sort()
        spread = _iqr_spread(samples)
        if spread <= steady_rtol or rounds >= max_rounds:
            return Timing(us=samples[len(samples) // 2],
                          samples=tuple(samples), spread=spread,
                          steady=spread <= steady_rtol, rounds=rounds)


def measure_us(fn, *args, warmup: int = 1, iters: int = 3,
               steady_rtol: float = 0.25, max_rounds: int = 3,
               device=None) -> float:
    """Median time per call in microseconds (:func:`measure`'s ``us``)."""
    return measure(fn, *args, warmup=warmup, iters=iters,
                   steady_rtol=steady_rtol, max_rounds=max_rounds,
                   device=device).us
