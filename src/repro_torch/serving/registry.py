"""Multi-model serving fleet: several image models behind one front door
(the reference's ``repro/serving/registry.py``).

:class:`ModelRegistry` gives each registered model its own
:class:`CnnEngine` (its own buckets, pack-once slabs, SLO policy and
latency accounting).  The engines share one device slot budget: a model
whose slot pool (``max_batch * staging_depth``) would oversubscribe it is
refused at registration.  One :meth:`~ModelRegistry.step` drives every
engine's stage -> launch -> retire tick, so the models' H2D copies and
forwards interleave on the card's stream.

Front door: ``submit(model, req)`` goes through the engine's admission
control (``try_submit``); a shed request is reported (False and
``req.shed``), never dropped, and a quarantined engine sheds at the front
door.  ``stats()`` gives each model's engine stats and the fleet's
aggregates; ``run_until_done`` raises :class:`DrainTimeout` with each
engine's drain report when the fleet does not drain in its step budget.
"""
from __future__ import annotations

from typing import Dict, Optional

from .cnn import CnnEngine, CnnServeConfig, ImageRequest
from .faults import FaultInjector
from .scheduler import DrainTimeout


class ModelRegistry:
    """Named :class:`CnnEngine` fleet with a shared device slot budget."""

    def __init__(self, *, slot_budget: Optional[int] = None):
        assert slot_budget is None or slot_budget >= 1
        self.slot_budget = slot_budget
        self.engines: Dict[str, CnnEngine] = {}

    # -- registration -------------------------------------------------------
    @property
    def slots_used(self) -> int:
        return sum(e.sched.n_slots for e in self.engines.values())

    def register(self, name: str, cfg, scfg: CnnServeConfig, *, params=None,
                 seed: int = 0, faults: Optional[FaultInjector] = None,
                 clock=None, device="cuda") -> CnnEngine:
        """Build and register one model's engine under ``name`` on
        ``device``.  Raises when the engine's slot pool would exceed the
        fleet's remaining budget: oversubscription fails at registration,
        not as memory pressure under load."""
        if name in self.engines:
            raise ValueError(f"model {name!r} already registered")
        need = scfg.max_batch * scfg.staging_depth
        if (self.slot_budget is not None
                and self.slots_used + need > self.slot_budget):
            raise ValueError(
                f"registering {name!r} needs {need} slots but only "
                f"{self.slot_budget - self.slots_used} of "
                f"{self.slot_budget} remain; shrink max_batch or "
                f"staging_depth")
        eng = CnnEngine(cfg, scfg, params=params, seed=seed, faults=faults,
                        clock=clock, device=device)
        self.engines[name] = eng
        return eng

    def export_state(self) -> dict:
        """Each model's host-side state a restart needs to rebuild the
        fleet."""
        return {name: eng.export_state()
                for name, eng in self.engines.items()}

    def __contains__(self, name: str) -> bool:
        return name in self.engines

    def __getitem__(self, name: str) -> CnnEngine:
        if name not in self.engines:
            raise KeyError(f"unknown model {name!r}; "
                           f"registered: {sorted(self.engines)}")
        return self.engines[name]

    # -- front door ---------------------------------------------------------
    def submit(self, model: str, req: ImageRequest) -> bool:
        """Route one request to its model's engine through admission
        control; False means shed (``req.shed`` set, the engine's
        ``images_shed`` counted).  A quarantined engine sheds at the front
        door (reason ``"unhealthy"``)."""
        return self[model].try_submit(req)

    def step(self):
        """One fleet tick: every engine stages, launches and retires; the
        launches are asynchronous, so the engines' copies and forwards
        interleave on the card within one pass."""
        for eng in self.engines.values():
            eng.step()

    @property
    def idle(self) -> bool:
        return all(e.drained for e in self.engines.values())

    def drain_report(self) -> dict:
        return {name: eng.drain_report()
                for name, eng in self.engines.items()}

    def run_until_done(self, max_steps: int = 100_000) -> dict:
        """Step the fleet until every engine drains; returns the per-engine
        drain report.  Raises :class:`DrainTimeout` (report attached) when
        requests are still in flight after ``max_steps``."""
        for _ in range(max_steps):
            if self.idle:
                return self.drain_report()
            self.step()
        if self.idle:
            return self.drain_report()
        report = self.drain_report()
        stuck = sorted(n for n, r in report.items() if not r["drained"])
        raise DrainTimeout(
            f"fleet not drained after {max_steps} steps; stuck engines: "
            f"{stuck}", report)

    def reset_metrics(self):
        for eng in self.engines.values():
            eng.reset_metrics()

    # -- accounting ---------------------------------------------------------
    def stats(self) -> dict:
        """Per-model engine stats plus fleet aggregates."""
        per = {name: eng.stats() for name, eng in self.engines.items()}
        return {
            "models": per,
            "fleet": {
                "images_completed": sum(s["images_completed"]
                                        for s in per.values()),
                "images_shed": sum(s["images_shed"] for s in per.values()),
                "images_expired": sum(s["images_expired"]
                                      for s in per.values()),
                "health": {name: s["health"]["state"]
                           for name, s in per.items()},
                "degraded_buckets": {name: s["degraded_buckets"]
                                     for name, s in per.items()
                                     if s["degraded_buckets"]},
                "accounting_balanced": all(s["accounting"]["balanced"]
                                           for s in per.values()),
                "imgs_per_s": sum(s["imgs_per_s"] for s in per.values()),
                "goodput_imgs_per_s": sum(s["goodput_imgs_per_s"]
                                          for s in per.values()),
                "worst_p99_ms": max(
                    (s["latency_ms"]["p99"] for s in per.values()),
                    default=0.0),
                "slots_used": self.slots_used,
                "slot_budget": self.slot_budget,
            },
        }
