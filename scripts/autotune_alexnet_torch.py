"""Measured per-layer autotune of AlexNet's conv layers on the card: the
PyTorch/CUDA port's counterpart of ``scripts/autotune_alexnet.py``.

For each conv layer it measures the CUDA kernels' block tiles through the
served dispatch (device time: CUDA events, L2 flushed, median of
``--iters``; ``repro_torch/core/autotune.py``), keeps the fastest, and
writes the port's plan cache, which ``CnnEngine`` loads at build.  Every
candidate gives the default plan's bits; ``--check-equal`` checks that on
the card for every candidate.

    PYTHONPATH=src python scripts/autotune_alexnet_torch.py \\
        [--batch 8] [--budget 8] [--iters 10] [--hill-climb] \\
        [--check-equal] [--cache PATH] [--out PATH] [--check]
    PYTHONPATH=src python scripts/autotune_alexnet_torch.py --check \\
        --from-cache            # check a cache's recorded numbers, any host

It tunes the full-width f32 model (image 227) on route ``pallas``.
``--check`` exits 1 if any layer's tuned time exceeds its default time,
in this run's rows and in every entry of the cache written; with
``--from-cache`` it tunes nothing and checks the cache's entries (an
empty cache fails).
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.autotune import (  # noqa: E402
    PlanCache, autotune_alexnet, backend_kind, default_cache_path)


def slower_entries(cache: PlanCache) -> list:
    """Keys of the cache's entries whose tuned time exceeds the default's."""
    return [k for k, e in cache.entries.items()
            if e.get("stats", {}).get("tuned_us", 0)
            > e.get("stats", {}).get("default_us", 0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--budget", type=int, default=8,
                    help="most candidates measured a layer")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a candidate (a round)")
    ap.add_argument("--hill-climb", action="store_true",
                    help="walk the tile grid from the winner")
    ap.add_argument("--check-equal", action="store_true",
                    help="check every candidate's output bit-equal to the "
                         "default plan's")
    ap.add_argument("--cache", default=None,
                    help="plan cache (default results/plans/"
                         "alexnet_torch.json)")
    ap.add_argument("--out", default=None,
                    help="also write every layer's rows to this JSON file")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if a layer's tuned time exceeds its "
                         "default time")
    ap.add_argument("--from-cache", action="store_true",
                    help="tune nothing; with --check, check the cache")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    cache_path = args.cache or default_cache_path(cfg.name)
    cache = PlanCache.load(cache_path)
    bad = []
    if not args.from_cache:
        print(f"autotune: {cfg.name} image {cfg.image_size} batch "
              f"{args.batch} on {backend_kind()} budget "
              f"{args.budget} iters {args.iters}", flush=True)
        results = autotune_alexnet(
            cfg, args.batch, iters=args.iters,
            max_candidates=args.budget, hill_climb=args.hill_climb,
            check_equal=args.check_equal, cache=cache,
            log=lambda s: print(s, flush=True))
        cache.save(cache_path)
        for r in results:
            print(f"autotune/{r['layer']}: default {r['default_us']:.2f} us "
                  f"(tile {r['default_tile']}) tuned {r['tuned_us']:.2f} us "
                  f"(tile {r['tile']}) speedup "
                  f"{r['default_us'] / r['tuned_us']:.3f}x candidates "
                  f"{r['candidates']} steady {r['steady']}")
            if r["tuned_us"] > r["default_us"]:
                bad.append(r["layer"])
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"config": dataclasses.asdict(cfg),
                           "batch": args.batch,
                           "backend": backend_kind(),
                           "cache": cache_path, "layers": results}, f,
                          indent=1)
    bad += slower_entries(cache)
    print(f"autotune/cache: {cache_path}, {len(cache.entries)} entries")
    if args.check and not cache.entries:
        print("autotune/CHECK_FAILED: the cache holds no entry")
        return 1
    if args.check:
        if bad:
            print(f"autotune/CHECK_FAILED: tuned slower than default: {bad}")
            return 1
        print("autotune/CHECK_OK: tuned <= default in every layer and entry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
