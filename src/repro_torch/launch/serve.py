"""Image-serving launcher: :class:`CnnEngine` over synthetic requests.

``python -m repro_torch.launch.serve --arch alexnet --full --route pallas``

Reports the per-layer resolved datapaths, img/s and latency percentiles,
and every bucket the engine degraded to the ``direct`` route.
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import CNN_ARCHS, get_config
from ..models.alexnet import layer_routes
from ..serving import (CnnEngine, CnnServeConfig, FaultInjector, FaultSpec,
                       ImageRequest, derive_seed)

CNN_ROUTES = ("auto", "direct", "winograd", "pallas")


def apply_cnn_route(cfg, route: str):
    """Map a conv route name onto the config's route knobs (``pallas`` is
    the hand-written-kernel route)."""
    assert route in CNN_ROUTES, route
    if route == "auto":
        return cfg
    return dataclasses.replace(cfg, use_winograd=route != "direct",
                               use_pallas=route == "pallas")


def serve_images(cfg, args) -> int:
    """Serve ``args.requests`` random images; returns the completed count."""
    for flag, item in (("sdc", "Queue 1, item 1"),
                       ("data_parallel", "Queue 1, item 6"),
                       ("workers", "Queue 1, item 4")):
        if getattr(args, flag, None):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not "
                                      f"ported yet (ROADMAP {item})")
    cfg = apply_cnn_route(cfg, getattr(args, "route", "auto"))
    cfg = dataclasses.replace(
        cfg, weight_prefetch=getattr(args, "prefetch", "on") == "on")
    routes = layer_routes(cfg)
    print("conv routes: " + " ".join(f"{n}={r}" for n, r in routes))
    slo_ms = getattr(args, "slo_ms", None)
    scfg = CnnServeConfig(
        max_batch=args.max_batch, slo_ms=slo_ms,
        dynamic_buckets=bool(slo_ms and getattr(args, "dynamic_buckets",
                                                False)),
        admission=bool(slo_ms and getattr(args, "admission", False)))
    faults = None
    if getattr(args, "chaos", False):
        faults = FaultInjector(
            seed=derive_seed(args.seed, cfg.name),
            specs={"launch.transient": FaultSpec(rate=0.1),
                   "retire.nonfinite": FaultSpec(rate=0.05)})
    eng = CnnEngine(cfg, scfg, seed=args.seed, faults=faults,
                    device=getattr(args, "device", "cuda"))
    rng = np.random.default_rng(args.seed)
    reqs = [ImageRequest(image=rng.standard_normal(
                (cfg.image_size, cfg.image_size, cfg.in_channels))
                .astype(np.float32),
                deadline_ms=getattr(args, "deadline_ms", None),
                retries=getattr(args, "retries", 2))
            for _ in range(args.requests)]
    for r in reqs:
        if scfg.admission:
            eng.try_submit(r)
        else:
            eng.submit(r)
    eng.run_until_done()
    s = eng.stats()
    done = sum(r.done for r in reqs)
    lat = s["latency_ms"]
    print(f"completed {done}/{len(reqs)} requests; "
          f"{s['imgs_per_s']:.1f} img/s over {s['batches_run']} batches "
          f"(avg occupancy {s['avg_occupancy']:.2f}, "
          f"buckets {s['bucket_counts']}) on {eng.device}")
    print(f"latency p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
          f"p99={lat['p99']:.1f}ms")
    acc = s["accounting"]
    print(f"accounting submitted={acc['submitted']} "
          f"completed={acc['completed']} shed={acc['shed']} "
          f"expired={acc['expired']} "
          f"balanced={'yes' if acc['balanced'] else 'NO'} | "
          f"health={s['health']['state']} retried={s['images_retried']}"
          + (f" faults_fired={faults.total_fired}" if faults else ""))
    for d in s["degradations"]:
        print(f"DEGRADED bucket {d['bucket']}: {d['from']} -> {d['to']} "
              f"after {d['failures']} {d['reason']} failures; its img/s "
              f"and latency include the {d['to']} route")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet", choices=CNN_ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the reduced one)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--route", default="auto", choices=CNN_ROUTES,
                    help="conv route (pallas = the hand-written CUDA "
                         "kernels)")
    ap.add_argument("--prefetch", default="on", choices=("on", "off"),
                    help="kept for parity with the reference; both values "
                         "launch the same kernels")
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--dynamic-buckets", action="store_true")
    ap.add_argument("--admission", action="store_true")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--chaos", action="store_true",
                    help="seeded transient launch failures + non-finite "
                         "logits")
    ap.add_argument("--sdc", action="store_true", help="not ported yet")
    ap.add_argument("--data-parallel", action="store_true",
                    help="not ported yet")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    serve_images(cfg, args)


if __name__ == "__main__":
    main()
