"""Serving launcher over synthetic requests.

``python -m repro_torch.launch.serve --arch alexnet --full --route pallas``
(or ``--arch vgg16``; ``--dtype bfloat16`` for the bf16 model) serves
images through :class:`CnnEngine` and reports the per-layer
resolved datapaths, img/s and latency percentiles, and every bucket the
engine degraded to the ``direct`` route; ``--sdc`` arms the
silent-data-corruption defense (ABFT checksums in the conv kernels,
pre-dispatch slab fingerprints, a bound on |logit|).

``python -m repro_torch.launch.serve --arch smollm-360m --full --requests 16
--max-len 512`` serves random prompts through the token :class:`Engine`
(kernel 5 on every decode step) and reports tokens/s and latency;
``--arch mamba2-2.7b`` serves the Mamba-2 SSM the same way (kernels 7 and
6 in every layer of each prefill, the one-token recurrence in decode), and
``--arch granite-moe-1b-a400m`` or ``--arch deepseek-v2-lite-16b`` the
mixture-of-experts models (kernel 5 in each of granite's GQA layers;
deepseek's MLA decodes in the absorbed form, with no kernel;
``--param-dtype bfloat16`` halves a full-width model's parameters);
``--arch jamba-v0.1-52b`` the hybrid (kernel 5 in its attention layers,
kernels 7 and 6 in its Mamba layers' prefills; at published widths it
needs more than one card unless compressed, ``models.lm.
quantize_linear_tree``, as ``chip_smoke.py`` phase 12 serves it);
``--arch whisper-tiny`` serves the encoder-decoder (128 random frames a
request; kernel 5 twice a layer a step, over the self and the cross
cache) and ``--arch phi-3-vision-4.2b`` the vision-language model (the
config's patches a request, prepended; kernel 5 at head_dim 96).

``python -m repro_torch.launch.serve --arch vgg16 --dtype bfloat16
--workers 2 --kill-worker`` serves the images through a
:class:`Supervisor` of worker processes (heartbeats, failover
re-dispatch, crash-consistent restart) and reports the fleet's
accounting, the failover bit-parity and each worker's card and kernel
launches; ``--kill-worker`` kills worker w0 mid-run, ``--chaos`` arms
seeded worker crashes and stalls.

Runs on the card unless ``--device cpu`` is given (the plain versions of
the kernels then run).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import CNN_ARCHS, LM_ARCHS, get_config
from ..models.alexnet import layer_routes
from ..serving import (CnnEngine, CnnServeConfig, Engine, FaultInjector,
                       FaultSpec, ImageRequest, Request, ServeConfig,
                       Supervisor, SupervisorConfig, WorkerModel,
                       derive_seed)

CNN_ROUTES = ("auto", "direct", "winograd", "pallas")


def apply_cnn_route(cfg, route: str):
    """Map a conv route name onto the config's route knobs (``pallas`` is
    the hand-written-kernel route)."""
    assert route in CNN_ROUTES, route
    if route == "auto":
        return cfg
    return dataclasses.replace(cfg, use_winograd=route != "direct",
                               use_pallas=route == "pallas")


def cnn_config(cfg, args):
    """The image model's config as the flags set it: route, weight
    prefetch, dtype."""
    cfg = apply_cnn_route(cfg, getattr(args, "route", "auto"))
    return dataclasses.replace(
        cfg, weight_prefetch=getattr(args, "prefetch", "on") == "on",
        dtype=getattr(args, "dtype", None) or cfg.dtype)


def _images(cfg, args):
    rng = np.random.default_rng(args.seed)
    return [ImageRequest(image=rng.standard_normal(
                (cfg.image_size, cfg.image_size, cfg.in_channels))
                .astype(np.float32),
                deadline_ms=getattr(args, "deadline_ms", None),
                retries=getattr(args, "retries", 2))
            for _ in range(args.requests)]


def serve_supervised(cfg, args) -> int:
    """Serve ``args.requests`` random images through ``args.workers``
    worker processes behind one :class:`Supervisor`; returns the completed
    count.  ``--kill-worker`` kills worker w0 mid-run (zero-loss
    failover); ``--chaos`` arms seeded per-worker crashes and stalls."""
    cfg = cnn_config(cfg, args)
    scfg = CnnServeConfig(max_batch=args.max_batch,
                          data_parallel=getattr(args, "data_parallel", False),
                          slo_ms=getattr(args, "slo_ms", None))
    chaos = None
    if getattr(args, "chaos", False):
        chaos = {"worker.crash": FaultSpec(rate=0.02, limit=1),
                 "worker.stall": FaultSpec(rate=0.05, delay_ms=50.0,
                                           limit=3)}
    device = getattr(args, "device", "cuda")
    sup = Supervisor((WorkerModel(cfg.name, cfg, scfg, seed=args.seed),),
                     SupervisorConfig(n_workers=args.workers,
                                      checkpoint_on_start=False),
                     seed=args.seed, chaos=chaos, device=device)
    reqs = _images(cfg, args)
    # kill right after an even-indexed submit: round-robin puts those on
    # w0, so the kill orphans an in-flight request
    kill_at = ((len(reqs) // 2) & ~1 if getattr(args, "kill_worker", False)
               else None)
    with sup:
        for i, r in enumerate(reqs):
            sup.submit(cfg.name, r)
            if kill_at is not None and i == kill_at:
                sup.kill_worker("w0", "operator:--kill-worker")
                kill_at = None
            sup.step()
        sup.run_until_done()
        sup.step()                  # refresh the workers' heartbeat reports
        acc = sup.accounting()
        lat = sup.latency.percentiles_ms()
        print(f"supervised fleet {cfg.name} ({cfg.dtype}) on {device}: "
              f"{args.workers} workers, completed "
              f"{acc['completed']}/{acc['submitted']} "
              f"(shed={acc['shed']} expired={acc['expired']} "
              f"failed_over={acc['failed_over']}) "
              f"balanced={'yes' if acc['balanced'] else 'NO'}")
        print(f"latency p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
              f"p99={lat['p99']:.1f}ms")
        if sup.failover_uids:
            par = sup.verify_bit_parity()
            print(f"failover bit-parity: {par['checked']} checked, "
                  f"{par['mismatched']} mismatched")
        for name, w in sup.stats()["workers"].items():
            print(f"worker {name}: {w['device_name']} restarts="
                  f"{w['restarts']} launches={w['launches']} degradations="
                  f"{w['degradations']}")
        deaths = [e for e in sup.events if e["event"] == "death"]
        if deaths:
            print("worker deaths: " + "; ".join(
                f"{e['worker']}({e['reason']})" for e in deaths))
    return acc["completed"]


def serve_images(cfg, args) -> int:
    """Serve ``args.requests`` random images; returns the completed count."""
    cfg = cnn_config(cfg, args)
    sdc = bool(getattr(args, "sdc", False))
    if sdc:
        cfg = dataclasses.replace(cfg, sdc_abft=True)
    routes = layer_routes(cfg)
    print("conv routes: " + " ".join(f"{n}={r}" for n, r in routes))
    slo_ms = getattr(args, "slo_ms", None)
    scfg = CnnServeConfig(
        max_batch=args.max_batch,
        data_parallel=getattr(args, "data_parallel", False), slo_ms=slo_ms,
        dynamic_buckets=bool(slo_ms and getattr(args, "dynamic_buckets",
                                                False)),
        admission=bool(slo_ms and getattr(args, "admission", False)),
        verify_slabs=sdc, screen_abs_max=1e6 if sdc else None)
    faults = None
    if getattr(args, "chaos", False):
        specs = {"launch.transient": FaultSpec(rate=0.1),
                 "retire.nonfinite": FaultSpec(rate=0.05)}
        if sdc:
            # slab bit flips and finite logit corruption against the
            # armed defense
            specs["slab.bitflip"] = FaultSpec(rate=0.1)
            specs["retire.plausible"] = FaultSpec(rate=0.05, magnitude=1e8)
        faults = FaultInjector(seed=derive_seed(args.seed, cfg.name),
                               specs=specs)
    eng = CnnEngine(cfg, scfg, seed=args.seed, faults=faults,
                    device=getattr(args, "device", "cuda"))
    reqs = _images(cfg, args)
    for r in reqs:
        if scfg.admission:
            eng.try_submit(r)
        else:
            eng.submit(r)
    eng.run_until_done()
    s = eng.stats()
    done = sum(r.done for r in reqs)
    lat = s["latency_ms"]
    print(f"{cfg.name} ({cfg.dtype}): completed {done}/{len(reqs)} "
          f"requests; "
          f"{s['imgs_per_s']:.1f} img/s over {s['batches_run']} batches "
          f"(avg occupancy {s['avg_occupancy']:.2f}, "
          f"buckets {s['bucket_counts']}) on "
          f"{', '.join(map(str, eng.devices))}")
    print(f"latency p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
          f"p99={lat['p99']:.1f}ms")
    acc = s["accounting"]
    print(f"accounting submitted={acc['submitted']} "
          f"completed={acc['completed']} shed={acc['shed']} "
          f"expired={acc['expired']} "
          f"balanced={'yes' if acc['balanced'] else 'NO'} | "
          f"health={s['health']['state']} retried={s['images_retried']}"
          + (f" faults_fired={faults.total_fired}" if faults else ""))
    if sdc:
        d = s["sdc"]
        print(f"sdc abft=on verify_slabs=on detections={d['detections']} "
              f"slab_integrity_failures={d['slab_integrity_failures']} "
              f"screen_nonfinite={d['screen_nonfinite']} "
              f"screen_magnitude={d['screen_magnitude']}")
    for d in s["degradations"]:
        print(f"DEGRADED bucket {d['bucket']}: {d['from']} -> {d['to']} "
              f"after {d['failures']} {d['reason']} failures; its img/s "
              f"and latency include the {d['to']} route")
    return done


def serve_tokens(cfg, args) -> int:
    """Serve ``args.requests`` random prompts; returns the completed
    count."""
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    scfg = ServeConfig(max_batch=args.max_batch, max_len=args.max_len,
                       cross_len=128 if cfg.family == "audio" else 0)
    eng = Engine(cfg, scfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(64, args.max_len - args.max_new)))
        req = Request(
            prompt=rng.integers(1, cfg.vocab_size, size=plen).tolist(),
            max_new=args.max_new)
        # the reference's request shapes: 128 encoder frames, or the
        # config's patches
        if cfg.family == "audio":
            req.frames = rng.standard_normal(
                (128, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.family == "vlm":
            req.patches = rng.standard_normal(
                (cfg.num_patches, 1024)).astype(np.float32) * 0.1
        reqs.append(req)
        eng.submit(req)
    eng.run_until_done()
    done = sum(r.done for r in reqs)
    lat = eng.latency.percentiles_ms()
    print(f"{cfg.name} ({cfg.param_dtype} params, {cfg.dtype} "
          f"activations): finished {done}/{len(reqs)} requests; "
          f"{eng.tokens_generated} tokens; decode throughput "
          f"{eng.decode_tokens_per_s:.1f} tok/s ({eng.decode_steps} batched "
          f"decode steps) on {eng.device}")
    print(f"latency p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
          f"p99={lat['p99']:.1f}ms")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet",
                    choices=CNN_ARCHS + LM_ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the reduced one)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256,
                    help="LM path: cache positions per slot")
    ap.add_argument("--max-new", type=int, default=16,
                    help="LM path: tokens generated per request")
    ap.add_argument("--route", default="auto", choices=CNN_ROUTES,
                    help="conv route (pallas = the hand-written CUDA "
                         "kernels)")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="CNN path: the model's dtype (default: the "
                         "config's, float32)")
    ap.add_argument("--param-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="LM path: the parameters' storage dtype (default: "
                         "the config's, float32)")
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
                         "logits; with --workers, seeded worker crashes "
                         "and stalls")
    ap.add_argument("--sdc", action="store_true",
                    help="CNN path: arm the silent-data-corruption defense "
                         "(ABFT checksums in the conv kernels, pre-dispatch "
                         "slab fingerprints, |logit| <= 1e6); with --chaos "
                         "also inject slab bit flips and finite logit "
                         "corruption")
    ap.add_argument("--data-parallel", action="store_true",
                    help="CNN path: split each bucket over every visible "
                         "card (each worker's, with --workers)")
    ap.add_argument("--workers", type=int, default=0,
                    help="CNN path: >0 serves through a Supervisor owning "
                         "this many worker processes (heartbeats, failover "
                         "re-dispatch, crash-consistent restart)")
    ap.add_argument("--kill-worker", action="store_true",
                    help="with --workers: kill worker w0 mid-run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.arch in CNN_ARCHS and args.workers > 0:
        serve_supervised(cfg, args)
    elif args.arch in CNN_ARCHS:
        serve_images(cfg, args)
    else:
        serve_tokens(cfg, args)


if __name__ == "__main__":
    main()
