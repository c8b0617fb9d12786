#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out numbers.json]   # checkout root, one GPU

Phases:
  1. device  — the card's name and power limit;
  2. build   — nvcc builds the conv kernels from ``src/repro_torch/csrc``
               (build seconds, ptxas registers / shared memory);
  3. kernels — each CUDA kernel at its AlexNet layer shapes (batch 8) held
               against its plain PyTorch version on the card, and timed
               beside it, beside the F.conv2d-based ``conv2d_ref`` of the
               same layer (TF32 off; timed only, the port never calls it)
               and beside its roofline bound;
  4. serve   — full-width AlexNet (random weights from a seed) on route
               ``pallas`` through ``CnnEngine(max_batch=8)``: 32 requests in
               mixed group sizes, with launch counts, bit-equality to
               ``apply`` at the served bucket, and agreement with the
               ``direct`` route.
The last line is ``{"ok": true, "device": {...}}``; any failed check exits
nonzero, and so does a run without a card or without the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs its plain version: both FP32 with different summation orders;
# a TF32 or other lower-precision body would miss this by far
TOL_KERNEL = 1e-5           # max|diff| <= TOL_KERNEL * max|plain|
TOL_ROUTE = 1e-3            # served vs direct route: <= TOL_ROUTE * max|logit|
BATCH = 8
ARRIVALS = (1, 3, 8, 5, 2, 7, 6)   # 32 requests in mixed group sizes
TIMING_ITERS = 20


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(torch, fn, iters=TIMING_ITERS):
    """(device ms, host ms) of one call, each the mean over ``iters``.

    Device: CUDA events around each call, with the 50 MB L2 flushed before
    each (a serving forward finds every layer's weights evicted by the
    others).  A spin kernel queued ahead of the start event keeps the card
    busy while the host enqueues the call, so the events bracket the
    call's device work and not the Python that launches it.  Host: the
    time the call takes to return, i.e. to enqueue its work."""
    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")
    enqueue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    # spin for three times the slowest warm enqueue and at least 5 ms, at
    # up to 2 GHz: a call the host is slow to enqueue must not leave the
    # card idle inside the events
    cycles = int(max(3 * max(enqueue[1:]), 5e-3) * 2e9)
    total = host = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters, host / iters * 1e3


def layer_cases(torch, np, cfg, params):
    """(kernel name, layer, spec, x, w, b, slab, plan) at the main path's
    shapes: each layer's input as the served forward gives it."""
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import _kernel_weight_plan, _spec_fusion, \
        dispatch_conv, plan_knobs, resolve_kernel
    rng = np.random.default_rng(0)
    specs = [s.with_route("pallas") for s in alexnet.layer_specs(cfg)]
    slabs = alexnet.pack_serving_slabs(params, cfg, BATCH)
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)),
        dtype=torch.float32, device="cuda")
    cases = []
    for i, spec in enumerate(specs):
        name = f"conv{i + 1}"
        p = params[name]
        kernel = resolve_kernel(spec, in_hw=x.shape[1])
        lrn, pool = _spec_fusion(spec)
        plan = _kernel_weight_plan(spec, kernel, tuple(x.shape),
                                   tuple(p["w"].shape), lrn=lrn, pool=pool,
                                   knobs=plan_knobs())
        kname = ("conv_direct" if kernel == "cuda-direct"
                 else "conv_winograd_fused" if plan.fused
                 else "conv_winograd")
        cases.append((kname, name, spec, x, p["w"], p["b"],
                      slabs[name].data, plan))
        # the next layer's input: this layer's output on the plain route
        x = dispatch_conv(spec.with_route("direct"), x, p["w"], p["b"])
    return cases


def flops_bytes(kname, x, out, plan):
    """(operations, bytes) the layer must do and move: each input, weight,
    bias and output byte once (the slab's real entries, not its channel or
    K padding, which no kernel reads); multiply-adds count 2 operations,
    in the Winograd domain for the Winograd kernels."""
    B = x.shape[0]
    if kname == "conv_direct":
        taps = plan.r * plan.r
        madds = B * plan.out_h * plan.out_w * plan.Kfull * plan.C * taps
    else:
        taps = plan.n * plan.n
        tiles = -(-plan.out_h // plan.m) * -(-plan.out_w // plan.m)
        madds = B * tiles * taps * plan.C * plan.Kfull
    weights = taps * plan.C * plan.Kfull
    nbytes = 4 * (x.numel() + weights + plan.Kfull + out.numel())
    return 2 * madds, nbytes


def phase_kernels(torch, np, cfg, params):
    from repro_torch.kernels.conv import direct, winograd
    from repro_torch.kernels.conv.ref import conv2d_ref
    rows = {}
    for kname, layer, spec, x, w, b, slab, plan in layer_cases(
            torch, np, cfg, params):
        lrn = spec.lrn if spec.fuse_lrn else None
        pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
        if kname == "conv_direct":
            def kern():
                return direct.conv2d_direct(
                    x, w, b, slab, stride=spec.stride, padding=spec.padding,
                    relu=True, groups=spec.groups, lrn=lrn, pool=pool)

            def plain():
                return direct.conv2d_direct_plain(x, slab, b, plan,
                                                  relu=True, lrn=lrn,
                                                  pool=pool)
        else:
            def kern():
                return winograd.conv2d_winograd(
                    x, w, b, slab, padding=spec.padding, relu=True,
                    groups=spec.groups, lrn=lrn, pool=pool)

            def plain():
                return winograd.conv2d_winograd_plain(x, slab, b, plan,
                                                      relu=True, lrn=lrn,
                                                      pool=pool)

        def library():
            return conv2d_ref(x, w, b, stride=spec.stride,
                              padding=spec.padding, groups=spec.groups,
                              relu=True, lrn=lrn, pool=pool)

        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        check(got.shape == ref.shape, f"{layer}: shape {tuple(got.shape)} "
              f"!= {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{layer}: non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        lib_err = float((got - library()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops, nbytes = flops_bytes(kname, x, got, plan)
        smem = (direct.smem_bytes(plan, pool) if kname == "conv_direct"
                else winograd.smem_bytes(plan, lrn, pool))
        bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                    >= nbytes / PEAK_BYTES_PER_S else "bytes")
        print(f"kernel {kname} {layer}: in {tuple(x.shape)} out "
              f"{tuple(got.shape)} slab {tuple(slab.shape)} | max_abs_err "
              f"{err:.3e} (max|plain| {scale:.3e}, rel {err / scale:.3e}, "
              f"tol {TOL_KERNEL:g} rel; "
              f"vs conv2d_ref {lib_err:.3e}) | kernel_ms {ms:.4f} (host "
              f"enqueue {host_ms:.4f} ms) plain_ms "
              f"{plain_ms:.4f} library_ms(conv2d_ref, F.conv2d TF32 off) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B) | dynamic smem/block "
              f"{smem} B")
        check(err <= TOL_KERNEL * scale,
              f"{layer}: kernel disagrees with its plain version: {err} > "
              f"{TOL_KERNEL} * {scale}")
        row = rows.setdefault(kname, {
            "name": kname, "layers": [], "max_abs_err": 0.0, "ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "flop": 0, "bytes": 0, "per_layer": []})
        row["layers"].append(layer)
        row["per_layer"].append({
            "layer": layer, "in": list(x.shape), "out": list(got.shape),
            "slab": list(slab.shape), "max_abs_err": err,
            "max_abs_plain": scale, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "flop": flops, "bytes": nbytes, "smem_bytes": smem})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms),
                         ("flop", flops), ("bytes", nbytes)):
            row[key] += val
    return rows


def phase_serve(torch, np, cfg, params):
    from repro_torch.kernels.conv import ops
    from repro_torch.models import alexnet
    from repro_torch.serving import CnnEngine, CnnServeConfig, ImageRequest
    rng = np.random.default_rng(1)

    def requests(n):
        return [ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)) for _ in range(n)]

    eng = CnnEngine(cfg, CnnServeConfig(max_batch=BATCH), params=params)
    # warm-up: pack every bucket's slabs and launch each shape once
    warm = requests(sum(eng.buckets))
    for size in eng.buckets:
        for r in warm[:size]:
            eng.submit(r)
        warm = warm[size:]
        eng.run_until_done()
    eng.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reqs = requests(sum(ARRIVALS))
    ops.reset_launch_counts()
    i = 0
    for size in ARRIVALS:
        for r in reqs[i:i + size]:
            eng.submit(r)
        i += size
        eng.step()
    eng.run_until_done()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats()

    acc = s["accounting"]
    check(acc["completed"] == len(reqs) and acc["balanced"],
          f"serve accounting: {acc}")
    check(all(r.done for r in reqs), "a request did not complete")
    check(s["batches_failed"] == 0 and not s["degradations"],
          f"failed batches or degradation: {s['batches_failed']} "
          f"{s['degradations']}")
    nb = s["batches_run"]
    check(nb > 0, "no batch ran")
    per_forward = {"conv_direct": 2, "conv_winograd": 2,
                   "conv_winograd_fused": 1}
    for k, n in per_forward.items():
        check(counts[k] == n * nb, f"{k}: {counts[k]} launches for {nb} "
              f"batches, expected {n} per forward")

    served = np.stack([r.logits for r in reqs])
    check(served.shape == (len(reqs), cfg.num_classes)
          and np.isfinite(served).all(), "served logits malformed")
    by_uid = {r.uid: r for r in reqs}
    groups = {r.served_group for r in reqs}
    for grp in groups:
        first = by_uid[grp[0]]
        x = np.zeros((first.served_bucket, cfg.image_size, cfg.image_size,
                      cfg.in_channels), np.float32)
        for row, uid in enumerate(grp):
            x[row] = by_uid[uid].image
        ref = alexnet.apply(params, cfg, torch.as_tensor(x, device="cuda"))
        ref = ref.cpu().numpy()
        for row, uid in enumerate(grp):
            check(np.array_equal(by_uid[uid].logits, ref[row]),
                  f"served logits of request {uid} are not bit-equal to "
                  f"apply at bucket {first.served_bucket}")
    cfg_d = dataclasses.replace(cfg, use_winograd=False, use_pallas=False)
    direct = alexnet.apply(params, cfg_d, torch.as_tensor(
        np.stack([r.image for r in reqs]), device="cuda")).cpu().numpy()
    dmax = float(np.abs(served - direct).max())
    lmax = float(np.abs(direct).max())
    print(f"serve: served vs direct route max|d| {dmax:.3e} "
          f"(max|logit| {lmax:.3e}, rel {dmax / lmax:.3e})")
    check(dmax <= TOL_ROUTE * lmax, f"served logits off the direct route: "
          f"{dmax} > {TOL_ROUTE} * {lmax}")
    lat = s["latency_ms"]
    return {"completed": acc["completed"], "batches": nb,
            "bucket_counts": s["bucket_counts"],
            "imgs_per_s": s["imgs_per_s"], "p50_ms": lat["p50"],
            "p99_ms": lat["p99"], "peak_mem_bytes": peak,
            "launches": counts, "served_vs_direct_max_abs": dmax,
            "max_abs_logit": lmax}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke run of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--out", help="also write every number of the run to "
                    "this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models import alexnet
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT}/src: {e}",
              file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{lib.build_seconds:.2f} s) -> {lib.path}")
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line or "Used" in line \
                or "spill" in line:
            print("ptxas:", line.strip())

    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    params = alexnet.init(0, cfg, device="cuda")
    rows = phase_kernels(torch, np, cfg, params)
    serve = phase_serve(torch, np, cfg, params)

    replaces = {"conv_direct": "src/repro/kernels/conv/direct.py:189",
                "conv_winograd": "src/repro/kernels/conv/winograd.py:297",
                "conv_winograd_fused":
                    "src/repro/kernels/conv/winograd.py:344"}
    sources = {"conv_direct": "src/repro_torch/csrc/conv_direct.cu",
               "conv_winograd": "src/repro_torch/csrc/conv_winograd.cu",
               "conv_winograd_fused": "src/repro_torch/csrc/conv_winograd.cu"}
    kernels = []
    for kname, row in rows.items():
        bound_by = ("operations" if row["flop"] / PEAK_FP32_FLOPS
                    >= row["bytes"] / PEAK_BYTES_PER_S else "bytes")
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname],
            "launches": serve["launches"][kname],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": bound_by, "library_ms": row["library_ms"],
            "layers": row["layers"]})
    print(f"serve: {serve['completed']}/{sum(ARRIVALS)} over "
          f"{serve['batches']} batches {serve['bucket_counts']} | "
          f"{serve['imgs_per_s']:.2f} img/s p50 {serve['p50_ms']:.3f} ms "
          f"p99 {serve['p99_ms']:.3f} ms peak mem "
          f"{serve['peak_mem_bytes'] / 2 ** 20:.1f} MiB | launches "
          f"{serve['launches']} | on {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "serve": serve,
                       "per_layer": {k: r["per_layer"]
                                     for k, r in rows.items()},
                       "build_seconds": lib.build_seconds}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
