"""Slot-based continuous-batching token engine (paper §3.7 generalized; the
reference's ``repro/serving/engine.py``).

The paper batches images through the FC layers because FC throughput is
bound by the weight stream: each streamed weight must be reused S_batch
times.  LM decode is the same regime, so the engine keeps a fixed pool of
``max_batch`` cache slots and decodes all of them in one batched step, whose
attention is kernel 5 (``csrc/decode_attn.cu``) on the card.  Prefill runs
per request at admission, padded to a multiple of ``prefill_bucket`` (an
SSM model's at exact length: its state would absorb pad tokens; its
prefill runs kernels 7 and 6 in every layer), and its one-row cache is
copied into the request's slot, buffer by buffer.  The mixture-of-experts
models serve the same way: their pad tokens are routed and take expert
capacity as in the reference, and an MLA layer decodes in the absorbed
form, with no kernel.  The encoder-decoder (``audio``) prefills with the
request's ``frames`` (zeros of (cross_len, d_model) when it has none),
which fill each layer's cross cache, and decodes with kernel 5 twice a
layer, over the self cache and over the slot's encoder rows.  The
vision-language model (``vlm``) prefills with the request's ``patches``
(zeros of (num_patches, 1024) when it has none) before the prompt, so a
slot's length counts the patch prefix.

Slot and queue bookkeeping is the shared :class:`SlotScheduler`, as for
:class:`CnnEngine`; this module owns the decode state: per-layer caches
(GQA: (max_batch, max_len, KV, D) K and V in ``cfg.dtype``; MLA: the
latent (max_batch, max_len, kv_lora) and the rope key (max_batch,
max_len, rope_dim); SSM: the conv windows and the f32 state; a cross
layer's encoder K and V (max_batch, cross_len, KV, D) and rows written;
VLM: num_patches + max_len positions),
preallocated and updated in place, the slots' lengths (on the host,
uploaded with the active mask once a step) and their last tokens (on the
device).  The engine runs eagerly; each step ends in one host sync, the
fetch of the new tokens.

Request lifecycle: submit() -> queued -> admitted (prefill) -> decoding ->
finished (max_new, max_len or eos).  The max_len test counts text
positions, the length less a VLM's patch prefix: the reference counts
the prefix too, and so retires a VLM request early once the prefix
passes max_len (ROADMAP Queue 3).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import ArchConfig
from ..core.device import resolve_device
from ..models import model_for
from .scheduler import LatencyTracker, SlotScheduler


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    prefill_bucket: int = 64          # prompts padded to multiples
    eos_id: int = -1                  # -1: disabled
    cross_len: int = 0                # enc-dec: encoder rows (0: 128)


@dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    uid: int = field(default_factory=itertools.count().__next__)
    frames: Optional[np.ndarray] = None       # audio family: (T, d_model)
    patches: Optional[np.ndarray] = None      # vlm family: (P, 1024)
    # outputs
    generated: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0


class Engine:
    def __init__(self, cfg: ArchConfig, scfg: ServeConfig, *, params=None,
                 seed: int = 0, device="cuda"):
        if cfg.family == "cnn":
            raise ValueError("Engine serves language models; CnnEngine "
                             "serves CNN configs")
        self.cfg, self.scfg = cfg, scfg
        self.device = resolve_device(device)
        self.mod = model_for(cfg)
        self.params = (params if params is not None
                       else self.mod.init(seed, cfg, device=self.device))
        B = scfg.max_batch
        self._cache_kw = ({"cross_len": scfg.cross_len or 128}
                          if cfg.family == "audio" else {})
        # positions of a slot before its text: a VLM's patch prefix
        self._prefix = cfg.num_patches if cfg.family == "vlm" else 0
        self.cache = self.mod.cache_init(cfg, B, scfg.max_len,
                                         device=self.device,
                                         **self._cache_kw)
        self.lengths = np.zeros(B, np.int32)
        self.last_tokens = torch.zeros((B, 1), dtype=torch.long,
                                       device=self.device)
        self.sched = SlotScheduler(B)
        self.latency = LatencyTracker()
        self.tokens_generated = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0       # host time in batched decodes

    # -- views over the shared scheduler -------------------------------------
    @property
    def queue(self):
        return self.sched.queue

    @property
    def active(self) -> np.ndarray:
        return self.sched.active

    @property
    def slot_req(self) -> List[Optional[Request]]:
        return self.sched.slot_req

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.sched.submit(req)

    def _pad_len(self, n: int) -> int:
        # an SSM's state would absorb the pad tokens, so the SSM and hybrid
        # families prefill at exact length, as in the reference
        if self.cfg.family in ("ssm", "hybrid"):
            return n
        b = self.scfg.prefill_bucket
        return min(-(-n // b) * b, self.scfg.max_len)

    def _admit(self):
        for slot, req in self.sched.admit():
            prompt = req.prompt[: self.scfg.max_len - req.max_new]
            plen = len(prompt)
            toks = np.zeros((1, self._pad_len(plen)), np.int64)
            toks[0, :plen] = prompt
            one = self.mod.cache_init(self.cfg, 1, self.scfg.max_len,
                                      device=self.device, **self._cache_kw)
            logits, one, _ = self.mod.apply(
                self.params, self.cfg, torch.from_numpy(toks).to(self.device),
                mode="prefill", caches=one, **self._extras(req))
            # insert: every cache of the one-row prefill into the slot (a
            # cross layer's too); prefill over the padded tail also wrote
            # attention entries past plen, which lengths masks
            for full, row in zip(self.cache, one):
                for kind, bufs in full.items():
                    for name, buf in bufs.items():
                        buf[slot] = row[kind][name][0]
            self.lengths[slot] = self._prefix + plen
            first_tok = int(logits[0, plen - 1].argmax())
            self.last_tokens[slot, 0] = first_tok
            req.generated.append(first_tok)
            self.tokens_generated += 1

    def _extras(self, req: Request) -> dict:
        """The prefill's frames or patches, one row, on the device."""
        if self.cfg.family == "audio":
            fr = req.frames if req.frames is not None else np.zeros(
                (self._cache_kw["cross_len"], self.cfg.d_model), np.float32)
            return {"frames": torch.from_numpy(np.asarray(fr))[None].to(
                self.device)}
        if self.cfg.family == "vlm":
            pa = req.patches if req.patches is not None else np.zeros(
                (self.cfg.num_patches, 1024), np.float32)
            return {"patches": torch.from_numpy(np.asarray(pa))[None].to(
                self.device)}
        return {}

    def _retire(self):
        for slot, req in self.sched.occupied():
            text = int(self.lengths[slot]) - self._prefix
            limit = (len(req.generated) >= req.max_new or
                     text >= self.scfg.max_len - 1)
            eos = (self.scfg.eos_id >= 0 and req.generated and
                   req.generated[-1] == self.scfg.eos_id)
            if limit or eos:
                req.done = True
                req.t_done = time.perf_counter()
                self.latency.record(req.t_done - req.t_submit)
                self.sched.retire(slot)

    def decode(self, tokens, lengths: np.ndarray, caches):
        """One batched decode of ``tokens`` (max_batch, 1) at the slots'
        ``lengths`` -> logits (max_batch, V) f32; advances ``caches`` in
        place (an SSM layer reads no length: its state is its position)."""
        logits, _, _ = self.mod.apply(
            self.params, self.cfg, tokens, mode="decode",
            length=torch.from_numpy(lengths).to(self.device,
                                                non_blocking=True),
            caches=caches)
        return logits[:, 0]

    def step(self, before_decode=None):
        """One engine tick: admit waiting requests, decode all slots.
        ``before_decode(engine)``, if given, runs between the two, when
        a slot is active: the state the batched decode will read."""
        self._admit()
        mask = self.sched.active
        if not mask.any():
            return
        if before_decode is not None:
            before_decode(self)
        t0 = time.perf_counter()
        nxt = self.decode(self.last_tokens, self.lengths,
                          self.cache).argmax(-1)
        active = torch.from_numpy(mask).to(self.device, non_blocking=True)
        self.last_tokens = torch.where(active[:, None], nxt[:, None],
                                       self.last_tokens)
        nxt_host = nxt.cpu().numpy()            # the step's one host sync
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        self.lengths += mask
        for slot in np.nonzero(mask)[0]:
            self.sched.slot_req[slot].generated.append(int(nxt_host[slot]))
            self.tokens_generated += 1
        self._retire()

    def run_until_done(self, max_steps: int = 100_000, before_decode=None):
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step(before_decode)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.tokens_generated / self.decode_seconds \
            if self.decode_seconds else 0.0
