"""Deterministic synthetic data (the reference's ``repro/data/pipeline.py``),
numpy on the host, so a batch is bit-equal to the reference's for every
``(seed, step, process_index, process_count)``.

Sequences follow per-row affine recurrences x_{t+1} = (a*x_t + c) mod V with
(a, c) drawn from a small pattern set: fully learnable transitions, so smoke
training runs show real loss descent.  Generation is keyed by (seed, step,
process_index): restart-safe and shardable across hosts.  The
``frames`` / ``patches`` of the audio and vlm families are deterministic
low-amplitude noise from the same generator.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

N_PATTERNS = 8


def _make_patterns(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(2, min(vocab - 1, 97), size=N_PATTERNS)
    c = rng.integers(1, vocab - 1, size=N_PATTERNS)
    return a.astype(np.int64), c.astype(np.int64)


def synthetic_batches(*, batch: int, seq_len: int, vocab: int,
                      seed: int = 0, steps: Optional[int] = None,
                      family: str = "dense", d_model: int = 0,
                      num_patches: int = 0, frames_len: int = 0,
                      process_index: int = 0,
                      process_count: int = 1) -> Iterator[dict]:
    """Yields {"inputs", "targets"} (B, S) int32 (+ frames / patches for
    audio / vlm).  ``batch`` is the per-process batch; different
    ``process_index`` values yield disjoint streams."""
    a_pat, c_pat = _make_patterns(vocab, seed)
    step = 0
    while steps is None or step < steps:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, process_index, process_count]))
        pat = rng.integers(0, N_PATTERNS, size=batch)
        a, c = a_pat[pat], c_pat[pat]
        x = np.empty((batch, seq_len + 1), np.int64)
        x[:, 0] = rng.integers(0, vocab, size=batch)
        for t in range(seq_len):
            x[:, t + 1] = (a * x[:, t] + c) % vocab
        out = {"inputs": x[:, :-1].astype(np.int32),
               "targets": x[:, 1:].astype(np.int32)}
        if family == "audio":
            f = rng.standard_normal((batch, frames_len or seq_len, d_model))
            out["frames"] = (f * 0.1).astype(np.float32)
        if family == "vlm":
            p = rng.standard_normal((batch, num_patches, 1024))
            out["patches"] = (p * 0.1).astype(np.float32)
        yield out
        step += 1


def synthetic_images(*, batch: int, image_size: int, num_classes: int,
                     seed: int = 0, steps: Optional[int] = None):
    """Class-conditional gaussian blobs (NHWC f32 images, int32 labels)."""
    rng0 = np.random.default_rng(seed)
    protos = rng0.standard_normal((num_classes, 8, 8, 3)).astype(np.float32)
    step = 0
    while steps is None or step < steps:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        labels = rng.integers(0, num_classes, size=batch)
        base = protos[labels]
        up = np.repeat(np.repeat(base, image_size // 8 + 1, 1),
                       image_size // 8 + 1, 2)[:, :image_size, :image_size]
        noise = rng.standard_normal(up.shape).astype(np.float32)
        yield {"images": up + 0.3 * noise,
               "labels": labels.astype(np.int32)}
        step += 1
