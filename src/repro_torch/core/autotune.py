"""Live measured autotuner: per-layer search over the CUDA kernels' block
tiles (the reference's ``repro/core/autotune.py``, the paper's §4 design-
space exploration run on the card).

For one conv layer (a :class:`~repro_torch.nn.conv.ConvSpec` and its input
geometry) it enumerates the distinct launch plans over the knobs the CUDA
kernels really expose, the GEMM block tile of kernel 1's conv stage and of
kernels 2-3's batched GEMM (``tile_rows``/``tile_cols``; the launchers are
built for ``kernels/conv/direct.py::TILES`` and
``kernels/conv/winograd.py::TILES``), *measures* each through
:func:`~repro_torch.nn.conv.dispatch_conv` on its packed slab with the
shared timing discipline (``core/timing.py``: device time on the card,
median-of-k, steady-state guard), and persists the winner in a JSON plan
cache keyed by (geometry, backend kind, dtype, fusion flags).

Guarantees by construction:

* the default ``ConvPlan()`` is always the first candidate, so the tuned
  plan never measures slower than the default *in the sweep that chose
  it*;
* every candidate is **bit-equal** to the default plan: a block tile only
  re-blocks the launch, and each output stays one thread's FMA chain in
  ascending reduction order.  The rule the reference applied to
  ``c_block`` holds for every knob here: a knob that would change a sum's
  order is never a candidate, so the slab's blocking (``c_block``,
  ``k_block``, ``batch_block``) stays at the default;
* plans deduplicate by their *effective* launch (the resolved kernel plan
  plus the tile that actually launches), so ``weight_prefetch`` and
  ``row_parallel``, which launch the same kernels on the port, and a tile
  equal to the default never measure twice.  A tile the launcher is not
  built for on a layer's slab is not a candidate.

``scripts/autotune_alexnet_torch.py`` wraps :func:`autotune_alexnet` as a
CLI; ``models/alexnet.py::load_tuned_plans`` and ``serving/cnn.py`` load
the persisted cache (``results/plans/alexnet_torch.json``) at engine
build.  A plan cache is keyed to the card it was tuned on
(:func:`backend_kind`), so the reference's ``cpu-interpret`` entries and
another card's never match.
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..kernels.conv import direct as _direct_k
from ..kernels.conv import winograd as _winograd_k
from ..nn.conv import (ConvPlan, ConvSpec, DEFAULT_PLAN, _kernel_weight_plan,
                       _spec_fusion, dispatch_conv, kernel_tile,
                       pack_conv_weights, plan_knobs, resolve_kernel)
from .timing import Timing, measure

# default home of persisted plan caches: results/plans/ of the checkout
PLAN_DIR = Path(__file__).resolve().parents[3] / "results" / "plans"


# ---------------------------------------------------------------------------
# cache keys
# ---------------------------------------------------------------------------
def backend_kind(device="cuda") -> str:
    """The substrate a plan is measured on: ``"cpu"`` (the plain
    versions), or ``"cuda-sm{major}{minor}-{device name}"`` on the card,
    so a plan tuned on one card never steers another."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda-sm{major}{minor}-{torch.cuda.get_device_name(dev)}"


def plan_key(spec: ConvSpec, in_shape, *, dtype="float32",
             device="cuda") -> dict:
    """The cache identity of one tuning problem: the reference's fields
    (layer geometry, batch included, fusion flags, dtype) with this
    backend."""
    B, H, W, C = in_shape
    return {
        "kernel": spec.kernel, "stride": spec.stride,
        "padding": spec.padding, "groups": spec.groups,
        "route": spec.route, "winograd_m": spec.winograd_m,
        "relu": spec.relu, "fuse_bias": spec.fuse_bias,
        "fuse_lrn": spec.fuse_lrn, "fuse_pool": spec.fuse_pool,
        "pool_window": spec.pool_window, "pool_stride": spec.pool_stride,
        "batch": B, "h": H, "w": W, "c": C,
        "dtype": str(dtype).removeprefix("torch."),
        "backend": backend_kind(device),
    }


def key_str(key: dict) -> str:
    """Canonical string form (stable across field order and processes)."""
    return json.dumps(key, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------
@dataclass
class PlanCache:
    """A JSON-backed map from :func:`plan_key` to the tuned best plan, the
    reference's schema (version 1): each entry holds the key's fields, the
    winning plan and the measured numbers behind it."""
    path: str | None = None
    entries: dict = field(default_factory=dict)     # key_str -> entry dict

    @classmethod
    def load(cls, path) -> "PlanCache":
        """Load a persisted cache.  A missing file is the never-tuned state
        (empty, silent); an unreadable file, another schema version or a
        malformed entries table loads empty with a warning, since every
        plan is bit-equal to the default and a cache is only a hint."""
        path = os.fspath(path)
        cache = cls(path=path)
        if not os.path.exists(path):
            return cache
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"plan cache {path} is unreadable ({e}); "
                          f"falling back to default plans", stacklevel=2)
            return cache
        version = data.get("version") if isinstance(data, dict) else None
        if version != 1:
            warnings.warn(f"plan cache {path} has unknown schema version "
                          f"{version!r} (expected 1); falling back to "
                          f"default plans", stacklevel=2)
            return cache
        entries = data.get("entries", {})
        if not (isinstance(entries, dict)
                and all(isinstance(e, dict) and isinstance(e.get("plan"), dict)
                        and isinstance(e.get("key"), dict)
                        for e in entries.values())):
            warnings.warn(f"plan cache {path} has a malformed entries "
                          f"table; falling back to default plans",
                          stacklevel=2)
            return cache
        cache.entries = entries
        return cache

    def save(self, path=None) -> str:
        """Write the cache atomically (a temporary file, then a rename)."""
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.save needs a path")
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": self.entries}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    def put(self, key: dict, plan: ConvPlan, stats: dict | None = None):
        self.entries[key_str(key)] = {
            "key": dict(key), "plan": plan.to_dict(),
            "stats": dict(stats or {}),
        }

    def get(self, key: dict, *, any_batch: bool = False) -> ConvPlan | None:
        """Exact lookup; with ``any_batch`` fall back to an entry matching
        every field but the batch (a serving bucket reuses the tuned
        geometry rather than running untuned)."""
        hit = self.entries.get(key_str(key))
        if hit is None and any_batch:
            want = {k: v for k, v in key.items() if k != "batch"}
            for e in self.entries.values():
                have = {k: v for k, v in e["key"].items() if k != "batch"}
                if have == want:
                    hit = e
                    break
        return None if hit is None else ConvPlan.from_dict(hit["plan"])

    def stats(self, key: dict) -> dict | None:
        hit = self.entries.get(key_str(key))
        return None if hit is None else hit.get("stats")


def default_cache_path(name: str = "alexnet") -> str:
    """The port's own cache, beside the reference's ``<name>.json``."""
    return os.fspath(PLAN_DIR / f"{name}_torch.json")


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------
def kernel_tiles(kernel: str, dtype=torch.float32) -> tuple:
    """The (rows, columns) block tiles the kernel's launcher is built for
    at the layer's dtype (none off the CUDA kernels).  The tuner packs the
    slab in the filters' dtype, so a bfloat16 direct layer runs the
    tensor-core route and draws from its tiles, a float32 one from the
    FFMA route's."""
    if kernel == "cuda-winograd":
        return _winograd_k.TILES
    if kernel == "cuda-direct":
        return _direct_k.route_tiles(dtype)
    return ()


def _effective_signature(spec: ConvSpec, kernel: str, in_shape, w_shape,
                         plan: ConvPlan, dtype=torch.float32):
    """What the launch actually runs: the resolved kernel plan plus the
    tile that launches on a slab of ``dtype``.  Two plans with the same
    signature are the same launch; raises ValueError for a tile the
    kernel cannot launch."""
    lrn_p, pool = _spec_fusion(spec)
    knobs = plan_knobs(plan)
    p = _kernel_weight_plan(spec, kernel, tuple(in_shape), tuple(w_shape),
                            lrn=lrn_p, pool=pool, knobs=knobs)
    return kernel, p, kernel_tile(kernel, p, knobs, dtype)


def enumerate_plans(spec: ConvSpec, in_shape, w_shape, *,
                    max_candidates: int | None = None,
                    dtype=torch.float32) -> list[ConvPlan]:
    """All distinct candidate launch plans for one layer in ``dtype``,
    default first: the kernel's tile grid at that dtype crossed with
    ``weight_prefetch`` and ``row_parallel``, deduplicated by
    :func:`_effective_signature`, tiles the launcher cannot run on this
    slab left out, capped at ``max_candidates``.  Off the CUDA kernels the
    default plan is the only candidate."""
    kernel = resolve_kernel(spec, in_hw=(in_shape[1], in_shape[2]))
    if not kernel.startswith("cuda"):
        return [DEFAULT_PLAN]
    seen, out = set(), []

    def admit(plan: ConvPlan):
        try:
            sig = _effective_signature(spec, kernel, in_shape, w_shape, plan,
                                       dtype)
        except ValueError:
            return                  # not built for this tile on this slab
        if sig not in seen:
            seen.add(sig)
            out.append(plan)

    admit(DEFAULT_PLAN)             # tuned can never regress the default
    for rows, cols in kernel_tiles(kernel, dtype):
        for pref in (True, False):
            for rp in (False, True):
                admit(ConvPlan(weight_prefetch=pref, row_parallel=rp,
                               tile_rows=rows, tile_cols=cols))
    if max_candidates is not None:
        out = out[:max(max_candidates, 1)]
    return out


def _neighbors(plan: ConvPlan, tile, tiles) -> list[ConvPlan]:
    """Hill-climb moves: the built tiles one step along either axis of the
    tile grid from ``tile`` (the plan's effective tile)."""
    rows = sorted({t[0] for t in tiles})
    cols = sorted({t[1] for t in tiles})
    i, j = rows.index(tile[0]), cols.index(tile[1])
    steps = [(i + d, j) for d in (-1, 1)] + [(i, j + d) for d in (-1, 1)]
    return [ConvPlan(**{**plan.to_dict(), "tile_rows": rows[a],
                        "tile_cols": cols[b]})
            for a, b in steps
            if 0 <= a < len(rows) and 0 <= b < len(cols)
            and (rows[a], cols[b]) in tiles]


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def measure_plan(spec: ConvSpec, x, w, b, plan: ConvPlan, *,
                 warmup: int = 1, iters: int = 3) -> Timing:
    """Median time of the served dispatch under one plan: the slab packed
    once for the plan (as the serving engine stages it), then
    :func:`dispatch_conv` on it; device time on a CUDA tensor."""
    w_packed = pack_conv_weights(spec, tuple(x.shape), w, plan=plan)
    return measure(lambda: dispatch_conv(spec, x, w, b, w_packed=w_packed,
                                         plan=plan),
                   warmup=warmup, iters=iters, device=x.device)


def bit_equal(a, b) -> bool:
    """Same shape and the same bits (so -0.0 differs from +0.0, and a NaN
    equals the same NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def autotune_layer(spec: ConvSpec, x, w, b=None, *, warmup: int = 1,
                   iters: int = 3, max_candidates: int | None = None,
                   hill_climb: bool = False, check_equal: bool = False,
                   log=None):
    """Measure every candidate plan for one layer; return the winner.

    Returns ``(best_plan, rows)``: one record per measured candidate
    (``plan``, ``tile``, ``us``, ``spread``, ``steady``, ``default``),
    rows[0] the default plan.  A plan wins only by beating the best so far
    in this sweep.  ``hill_climb`` walks the tile grid from the winner
    (:func:`_neighbors`).  ``check_equal`` also checks that each
    candidate's output is bit-equal to the default's and raises
    AssertionError if one is not."""
    kernel = resolve_kernel(spec, in_hw=(x.shape[1], x.shape[2]))
    plans = enumerate_plans(spec, x.shape, w.shape,
                            max_candidates=max_candidates, dtype=w.dtype)
    y_ref = (dispatch_conv(spec, x, w, b, plan=DEFAULT_PLAN)
             if check_equal else None)
    rows, measured = [], {}

    def signature(plan):
        if not kernel.startswith("cuda"):
            return ("plain",), None
        sig = _effective_signature(spec, kernel, x.shape, w.shape, plan,
                                   w.dtype)
        return sig, sig[2]

    def run(plan: ConvPlan) -> float:
        sig, tile = signature(plan)
        if sig in measured:
            return measured[sig]
        if y_ref is not None:
            w_packed = pack_conv_weights(spec, tuple(x.shape), w, plan=plan)
            y = dispatch_conv(spec, x, w, b, w_packed=w_packed, plan=plan)
            if not bit_equal(y_ref, y):
                raise AssertionError(f"candidate plan {plan} is not "
                                     f"bit-equal to the default plan")
        t = measure_plan(spec, x, w, b, plan, warmup=warmup, iters=iters)
        measured[sig] = t.us
        rows.append({"plan": plan.to_dict(),
                     "tile": list(tile) if tile else None, "us": t.us,
                     "spread": t.spread, "steady": t.steady,
                     "default": plan == DEFAULT_PLAN})
        if log is not None:
            log(f"    {t.us:10.2f} us  tile {tile}  "
                f"{'steady' if t.steady else 'NOT steady'}")
        return t.us

    best, best_us = DEFAULT_PLAN, run(DEFAULT_PLAN)
    for plan in plans[1:]:
        us = run(plan)
        if us < best_us:
            best, best_us = plan, us

    tiles = kernel_tiles(kernel, w.dtype)
    if hill_climb and tiles:
        improved = True
        while improved:
            improved = False
            for nb in _neighbors(best, signature(best)[1], tiles):
                try:
                    us = run(nb)
                except ValueError:
                    continue        # not built for this tile on this slab
                if us < best_us:
                    best, best_us = nb, us
                    improved = True
    return best, rows


# ---------------------------------------------------------------------------
# network walker (AlexNet)
# ---------------------------------------------------------------------------
def alexnet_layer_geometries(cfg, batch: int):
    """(name, spec with the config's route, in_shape, w_shape) per conv
    layer: the shape chain ``models.alexnet.features`` walks."""
    from ..models import alexnet as ax
    route = ax._route(cfg)
    geoms, h, c_in = [], cfg.image_size, cfg.in_channels
    for i, (spec, c_out) in enumerate(zip(ax.layer_specs(cfg),
                                          cfg.conv_channels)):
        spec = spec.with_route(route)
        geoms.append((f"conv{i + 1}", spec, (batch, h, h, c_in),
                      (spec.kernel, spec.kernel, c_in // spec.groups, c_out)))
        h, c_in = spec.out_hw(h), c_out
    return geoms


def autotune_alexnet(cfg, batch: int, *, device="cuda", warmup: int = 1,
                     iters: int = 3, max_candidates: int | None = None,
                     hill_climb: bool = False, check_equal: bool = False,
                     cache: PlanCache | None = None, seed: int = 0,
                     log=None):
    """Tune every conv layer of an AlexNet config at one batch size on
    ``device``.

    Returns per-layer rows (layer, key, winning plan and tile, default and
    tuned us, candidates, whether the default's timing was steady, the
    candidates' rows) and writes each winner into ``cache`` when one is
    passed (the caller saves).  Layer inputs are drawn from ``seed`` in
    the config's dtype, as the reference draws them: a launch's time
    depends on its geometry and dtype, not its values."""
    from ..models.alexnet import DTYPES
    dev = torch.device(device)
    dt = DTYPES[cfg.dtype]
    rng = np.random.default_rng(seed)
    results = []
    for name, spec, in_shape, w_shape in alexnet_layer_geometries(cfg, batch):
        x = torch.as_tensor(rng.standard_normal(in_shape, np.float32),
                            device=dev).to(dt)
        w = torch.as_tensor(rng.standard_normal(w_shape, np.float32)
                            * np.float32(np.prod(w_shape[:3]) ** -0.5),
                            device=dev).to(dt)
        b = torch.zeros((w_shape[-1],), dtype=dt, device=dev)
        if log is not None:
            log(f"  {name}: in={in_shape} w={w_shape} "
                f"kernel={resolve_kernel(spec, in_hw=in_shape[1])}")
        best, rows = autotune_layer(
            spec, x, w, b, warmup=warmup, iters=iters,
            max_candidates=max_candidates, hill_climb=hill_climb,
            check_equal=check_equal, log=log)
        default = next(r for r in rows if r["default"])
        won = min(rows, key=lambda r: r["us"])
        stats = {"default_us": default["us"], "tuned_us": won["us"],
                 "candidates": len(rows), "tile": won["tile"],
                 "default_tile": default["tile"],
                 "steady": all(r["steady"] for r in rows)}
        key = plan_key(spec, in_shape, dtype=cfg.dtype, device=dev)
        if cache is not None:
            cache.put(key, best, stats)
        results.append({"layer": name, "key": key, "plan": best.to_dict(),
                        **stats, "rows": rows})
    return results


def load_alexnet_plans(cfg, batch: int, *, path=None, device="cuda",
                       any_batch: bool = True) -> dict:
    """Tuned plans for an AlexNet config, ``{"conv1": ConvPlan, ...}``,
    for every layer with a cache hit (the others run the default).  The
    key must match what :func:`autotune_alexnet` stored, geometry, dtype
    and this ``device``'s backend kind, so a plan tuned on one substrate
    never steers another."""
    path = path or default_cache_path(getattr(cfg, "name", "alexnet"))
    if not os.path.exists(path):
        return {}
    cache = PlanCache.load(path)
    plans = {}
    for name, spec, in_shape, _ in alexnet_layer_geometries(cfg, batch):
        key = plan_key(spec, in_shape, dtype=cfg.dtype, device=device)
        hit = cache.get(key, any_batch=any_batch)
        if hit is not None:
            plans[name] = hit
    return plans
