"""Host -> device stream buffer (the reference's ``repro/core/streambuf.py``;
the paper's §3.5 stream buffers at the input pipeline).

While step N computes, batch N+1 is already on its way to the card, so the
card never waits on the data pipeline.  A host thread pulls each batch
from the iterator, copies its arrays into pinned memory and starts their
copies to the device ``non_blocking`` on a side stream, with an event
recorded after them; at most ``depth`` batches are in flight.  ``next()``
makes the caller's current stream wait on that event before it hands the
batch over, and marks each tensor as used on that stream
(``record_stream``), so the allocator does not reuse the memory while the
compute stream may still read it.  On the CPU the arrays become tensors
and nothing is in flight.  An error of the iterator or of a copy surfaces
on ``next()``, after the batches before it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .device import resolve_device


def _to_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


class StreamBuffer:
    """Wrap a host batch iterator (dicts of numpy arrays or tensors) with a
    ``depth``-deep asynchronous prefetch to ``device``.  ``put_fn``, if
    given, replaces the copy: it maps a host batch to the batch ``next()``
    returns (run on the filling thread)."""

    def __init__(self, it: Iterator, *, depth: int = 2, device="cuda",
                 put_fn: Optional[Callable] = None):
        self._it = it
        self.device = resolve_device(device)
        self._put = put_fn
        self._stream = (torch.cuda.Stream(self.device)
                        if put_fn is None and self.device.type == "cuda"
                        else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _copy(self, batch):
        """(device batch, the event its copies end with, or None)."""
        if self._put is not None:
            return self._put(batch), None
        host = {k: _to_tensor(v) for k, v in batch.items()}
        if self._stream is None:
            return {k: t.to(self.device) for k, t in host.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _fill(self):
        try:
            for batch in self._it:
                self._q.put(self._copy(batch))
        except BaseException as e:      # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)     # a later next() stops too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch
