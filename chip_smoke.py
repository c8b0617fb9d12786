#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out numbers.json]   # checkout root, one GPU

Phases:
  1. device  — the card's name and power limit;
  2. build   — nvcc builds every kernel from ``src/repro_torch/csrc``
               (build seconds, ptxas registers / shared memory);
  3. kernels — each CUDA kernel at its AlexNet layer shapes (batch 8) held
               against its plain PyTorch version on the card, and timed
               beside it and beside its roofline bound: the conv kernels
               beside the F.conv2d-based ``conv2d_ref`` of the same layer,
               on f32 slabs and again on the ``conv_bfp`` slabs,
               the BFP matmul (fc6-fc8, bit-equal to its plain version)
               beside the f32 ``x @ w`` that ``fc_bfp`` replaces (TF32
               off; timed only, the port never calls either);
  4. serve   — full-width AlexNet (random weights from a seed) through
               ``CnnEngine(max_batch=8)``, 32 requests in mixed group sizes,
               twice: on route ``pallas`` in f32 (agreement with the
               ``direct`` route), then with ``fc_bfp`` and ``conv_bfp``
               (agreement with the f32 model within the BFP error); each
               with launch counts and bit-equality to ``apply`` at the
               served bucket;
  5. decode  — kernel 5 (decode attention) at smollm-360m's decode geometry
               (B=8, S=512, H=15, KV=5, D=64) and llama3.2-3b's (H=24,
               KV=8, D=128, S=2048), f32 and bf16, held against its plain
               version (and, within one bf16 step, against the plain
               version with f32 probabilities, the kernel's arithmetic) and
               timed in bf16 beside its bytes bound and
               ``scaled_dot_product_attention`` (timed only);
  6. lm      — full-width smollm-360m (random weights from a seed) through
               the token ``Engine(max_batch=8, max_len=512)``: 24 requests
               of 8-200 prompt tokens, 32 new tokens each, kernel 5 counted
               on every decode step, the logits of one mid-run step held
               against the plain decode attention on the same cache, and a
               reduced model's tokens against the CPU engine's.
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
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES_PER_S = 3.35e12
# kernel vs its plain version: both FP32 with different summation orders;
# a TF32 or other lower-precision body would miss this by far
TOL_KERNEL = 1e-5           # max|diff| <= TOL_KERNEL * max|plain|
TOL_ROUTE = 1e-3            # served vs direct route: <= TOL_ROUTE * max|logit|
# BFP served vs the f32 model: the JAX package's own bound for fc_bfp and
# conv_bfp (tests/test_fused_pipeline.py), <= TOL_BFP * max|logit|
TOL_BFP = 5e-2
# kernel 5 vs its plain version: the JAX package's bounds for its decode
# kernel (tests/test_kernels.py), rtol = atol; in bf16 the plain version
# rounds its probabilities to bf16, the kernel keeps them in f32
TOL_DECODE = {"float32": 1e-5, "bfloat16": 5e-2}
# kernel 5 vs the plain version with f32 probabilities (the arithmetic of
# the TPU kernel and of the CUDA kernel), (atol, rtol): in bf16 the two
# differ by their rounding to bf16, at most one step (2**-7 relative)
TOL_DECODE_F32P = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
# served decode logits with kernel 5 vs the plain decode attention on the
# same cache: <= TOL_LM * max|logit| (bf16 activations through 32 layers)
TOL_LM = 2e-2
PEAK_BF16_FLOPS = 989e12
# (name, B, S, H, KV, D): smollm-360m's and llama3.2-3b's decode geometry
DECODE_GEOMETRIES = (("smollm-360m", 8, 512, 15, 5, 64),
                     ("llama3.2-3b", 8, 2048, 24, 8, 128))
LM_ARCH = "smollm-360m"
LM_REQUESTS = 24
LM_MAX_NEW = 32
LM_PROBE_STEP = 40          # the decode step whose logits are re-checked
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
    others) by reading 64 MB: a read leaves clean lines, so the timed call
    does not pay for writing a flush buffer back to memory.  A spin kernel
    queued ahead of the start event keeps the card busy while the host
    enqueues the call, so the events bracket the call's device work and
    not the Python that launches it.  Host: the
    time the call takes to return, i.e. to enqueue its work."""
    flush = torch.zeros(64 * 2 ** 20 // 4, device="cuda")
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
        flush.sum()
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
    """The conv kernels on ``cfg``'s serving slabs (BFP-quantized under
    ``cfg.conv_bfp``)."""
    from repro_torch.kernels.conv import direct, winograd
    from repro_torch.kernels.conv.ref import conv2d_ref
    slab_kind = "conv_bfp" if cfg.conv_bfp else "f32"
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
        print(f"kernel {kname} {layer} ({slab_kind} slab): in "
              f"{tuple(x.shape)} out "
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


def phase_bfp(torch, np, cfg, params):
    """Kernel 4 at fc6, fc7 and fc8 with M = 8 rows: each layer's input as
    the served BFP forward gives it (conv features of the BFP config on the
    ``direct`` route, then the plain fc chain)."""
    from repro_torch.core import bfp as core_bfp
    from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp
    from repro_torch.kernels.bfp_matmul.ops import fc_block, \
        quantize_weights
    from repro_torch.kernels.bfp_matmul.ref import exact_matmul
    from repro_torch.models import alexnet
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)),
        dtype=torch.float32, device="cuda")
    cfg_d = dataclasses.replace(cfg, use_winograd=False, use_pallas=False)
    x = alexnet.features(params, cfg_d, x)
    row = {"name": "bfp_matmul", "layers": [], "max_abs_err": 0.0,
           "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "flop": 0, "bytes": 0, "per_layer": []}
    for j in range(len(cfg.fc_dims)):
        layer = f"fc{j + 6}"
        w, b = params[layer]["w"], params[layer]["b"]
        K, N = w.shape
        block = fc_block(K)
        wq, we = quantize_weights(w, block=block)
        w_deq = core_bfp.dequantize(bfp.reference_layout(wq, block), we,
                                    axis=0)

        def kern():
            return bfp.bfp_matmul(x, wq, we, block=block)

        def plain():
            return bfp.bfp_matmul_plain(x, wq, we, block=block)

        def library():
            return exact_matmul(x, w_deq)

        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        check(got.shape == ref.shape == (BATCH, N),
              f"{layer}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{layer}: non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        lib_err = float((got - library()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops = 2 * BATCH * K * N
        nbytes = (4 * x.numel() + wq.numel() + we.numel()
                  + 4 * got.numel())
        bound = max(flops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / PEAK_INT8_OPS
                    >= nbytes / PEAK_BYTES_PER_S else "bytes")
        print(f"kernel bfp_matmul {layer}: x {tuple(x.shape)} w ({K}, {N}) "
              f"block {block} | max_abs_err {err:.3e} (max|plain| "
              f"{scale:.3e}, gate: bit-equal; vs f32 x @ w_deq {lib_err:.3e})"
              f" | kernel_ms {ms:.4f} (host enqueue {host_ms:.4f} ms) "
              f"plain_ms {plain_ms:.4f} library_ms(the f32 FC that fc_bfp "
              f"replaces, x @ w TF32 off; not the same function) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} int8 op, {nbytes:.3e} B)")
        check(torch.equal(got, ref), f"{layer}: kernel is not bit-equal to "
              f"its plain version (max|diff| {err})")
        row["layers"].append(layer)
        row["per_layer"].append({
            "layer": layer, "in": list(x.shape), "w": [K, N],
            "block": block, "max_abs_err": err, "max_abs_plain": scale,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "flop": flops, "bytes": nbytes})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms),
                         ("flop", flops), ("bytes", nbytes)):
            row[key] += val
        x = ref + b
        if j < len(cfg.fc_dims) - 1:
            x = torch.relu(x)
    return row


def _count_modules():
    from repro_torch.kernels.bfp_matmul import ops as bfp_ops
    from repro_torch.kernels.conv import ops
    from repro_torch.kernels.decode_attn import ops as dec_ops
    return ops, bfp_ops, dec_ops


def launch_counts():
    counts = {}
    for mod in _count_modules():
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts():
    for mod in _count_modules():
        mod.reset_launch_counts()


def phase_serve(torch, np, cfg, params, *, cfg_f32=None):
    """Serve 32 requests; with ``cfg_f32`` (a BFP config's f32 twin) the
    logits are held against that model within the BFP error, else against
    the ``direct`` route."""
    from repro_torch.models import alexnet
    from repro_torch.serving import CnnEngine, CnnServeConfig, ImageRequest
    rng = np.random.default_rng(1)

    def requests(n):
        return [ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)) for _ in range(n)]

    eng = CnnEngine(cfg, CnnServeConfig(max_batch=BATCH), params=params,
                    device="cuda")
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
    reset_launch_counts()
    i = 0
    for size in ARRIVALS:
        for r in reqs[i:i + size]:
            eng.submit(r)
        i += size
        eng.step()
    eng.run_until_done()
    counts = launch_counts()
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
                   "conv_winograd_fused": 1,
                   "bfp_matmul": len(cfg.fc_dims) if cfg.fc_bfp else 0}
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
    images = torch.as_tensor(np.stack([r.image for r in reqs]),
                             device="cuda")
    if cfg_f32 is None:
        what, tol = "the direct route", TOL_ROUTE
        other = alexnet.apply(params, dataclasses.replace(
            cfg, use_winograd=False, use_pallas=False), images)
    else:
        what, tol = "the f32 model", TOL_BFP
        other = alexnet.apply(params, cfg_f32, images)
    other = other.cpu().numpy()
    dmax = float(np.abs(served - other).max())
    lmax = float(np.abs(other).max())
    print(f"serve {'bfp' if cfg.fc_bfp else 'f32'}: served vs {what} max|d| "
          f"{dmax:.3e} "
          f"(max|logit| {lmax:.3e}, rel {dmax / lmax:.3e}, tol {tol:g})")
    check(dmax <= tol * lmax, f"served logits off {what}: {dmax} > {tol} * "
          f"{lmax}")
    if cfg_f32 is not None:
        check(dmax > 0, "BFP logits equal the f32 model's: the quantized "
              "path did not run")
    lat = s["latency_ms"]
    return {"completed": acc["completed"], "batches": nb,
            "bucket_counts": s["bucket_counts"],
            "imgs_per_s": s["imgs_per_s"], "p50_ms": lat["p50"],
            "p99_ms": lat["p99"], "peak_mem_bytes": peak,
            "launches": counts, "served_vs_reference": what,
            "served_vs_reference_max_abs": dmax, "max_abs_logit": lmax}


def phase_decode(torch, np):
    """Kernel 5 at each decode geometry: held against its plain version in
    f32 and bf16, timed in bf16 (the served dtype) beside its bound and
    beside SDPA with the same length mask (``library_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attn as dec
    from repro_torch.kernels.decode_attn.ref import decode_attention_f32_ref
    rng = np.random.default_rng(3)
    row = {"name": "decode_attn", "geometries": [], "max_abs_err": 0.0}
    for name, B, S, H, KV, D in DECODE_GEOMETRIES:
        lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                               device="cuda")
        base = [torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device="cuda")
                for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))]
        geo = {"arch": name, "B": B, "S": S, "H": H, "KV": KV, "D": D,
               "lengths": lens.tolist()}
        for dtype_name in ("float32", "bfloat16"):
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in base)
            got = dec.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = dec.decode_attention_ref(q, k, v, lens)
            ref32 = decode_attention_f32_ref(q, k, v, lens)
            check(got.shape == ref.shape and got.dtype == q.dtype,
                  f"decode_attn {name}: {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"decode_attn {name}: non-finite output")
            diff = (got.float() - ref.float()).abs()
            tol = TOL_DECODE[dtype_name]
            excess = float((diff - tol * ref.float().abs()).max())
            err = float(diff.max())
            diff32 = (got.float() - ref32.float()).abs()
            atol, rtol = TOL_DECODE_F32P[dtype_name]
            excess32 = float((diff32 - rtol * ref32.float().abs()).max())
            err32 = float(diff32.max())
            print(f"kernel decode_attn {name} {dtype_name}: q {tuple(q.shape)}"
                  f" cache {tuple(k.shape)} | max_abs_err {err:.3e} "
                  f"(max|plain| {float(ref.float().abs().max()):.3e}, gate "
                  f"rtol = atol = {tol:g}, worst excess {excess:.3e}) | vs "
                  f"f32-probability plain {err32:.3e} (gate atol {atol:g} "
                  f"rtol {rtol:g}, worst excess {excess32:.3e})")
            check(excess <= tol, f"decode_attn {name} {dtype_name}: kernel "
                  f"disagrees with its plain version: |diff| exceeds "
                  f"{tol} + {tol} * |plain| by {excess}")
            check(excess32 <= atol, f"decode_attn {name} {dtype_name}: "
                  f"kernel disagrees with the f32-probability plain version:"
                  f" |diff| exceeds {atol} + {rtol} * |plain| by {excess32}")
            geo[f"max_abs_err_{dtype_name}"] = err
            geo[f"max_abs_err_f32p_{dtype_name}"] = err32
            row["max_abs_err"] = max(row["max_abs_err"], err)
        # timed in bf16, the dtype of the served caches
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def kern():
            return dec.decode_attention(q, k, v, lens)

        def plain():
            return dec.decode_attention_ref(q, k, v, lens)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)

        lib_err = float((kern().float() - library().float()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        valid = int(lens.clamp(max=S).sum())
        nbytes = (2 * valid * KV * D * k.element_size()
                  + 2 * q.numel() * q.element_size() + 4 * B)
        flops = 4 * valid * H * D
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / PEAK_BF16_FLOPS
                    >= nbytes / PEAK_BYTES_PER_S else "bytes")
        print(f"kernel decode_attn {name} bfloat16: kernel_ms {ms:.4f} (host "
              f"enqueue {host_ms:.4f} ms) plain_ms {plain_ms:.4f} "
              f"library_ms(SDPA, enable_gqa, length mask) {lib_ms:.4f} "
              f"(vs kernel {lib_err:.3e}) bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B over {valid} valid rows)")
        geo.update(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   flop=flops, bytes=nbytes, library_vs_kernel=lib_err)
        row["geometries"].append(geo)
    # the entry's numbers: the served geometry (smollm-360m's)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        row[key] = row["geometries"][0][key]
    return row


def _requests(rng, vocab, n, lo, hi, max_new):
    from repro_torch.serving import Request
    return [Request(prompt=rng.integers(1, vocab, size=int(
        rng.integers(lo, hi + 1))).tolist(), max_new=max_new)
        for _ in range(n)]


def profile_decode(torch, decode, steps=3):
    """Where ``decode()``'s time goes: (wall ms per call, untraced, with a
    host sync after each call as a served step has; then from a
    ``torch.profiler`` trace of ``steps`` calls: device busy ms per call,
    device events per call, kernel 5's ms per call and the 6 largest
    kernels by time).  The trace's entries are None when it holds no
    device events."""
    from torch.profiler import ProfilerActivity, profile
    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        decode()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            decode()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return wall_ms, None, None, None, None
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    kernel5 = sum(us for name, us in by_name.items() if "decode_attn" in name)
    return (wall_ms, sum(by_name.values()) / steps / 1e3, len(dev) / steps,
            kernel5 / steps / 1e3,
            [(name[:60], us / steps / 1e3) for name, us in top])


def _copy_cache(cache):
    return [{"attn": {n: t.clone() for n, t in c["attn"].items()}}
            for c in cache]


def phase_lm(torch, np):
    """Full-width smollm-360m through the token Engine; kernel 5 counted on
    every decode step; one mid-run step's logits re-run with the plain
    decode attention on a copy of the same cache."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.models import lm
    from repro_torch.nn import flash
    from repro_torch.serving import Engine, Request, ServeConfig
    cfg = get_config(LM_ARCH)
    scfg = ServeConfig(max_batch=BATCH, max_len=512, prefill_bucket=64)
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    params = lm.init(0, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    # warm-up: cuBLAS handles and every kernel once
    warm = Engine(cfg, scfg, params=params, device="cuda")
    for r in _requests(rng, cfg.vocab_size, 2, 8, 70, 2):
        warm.submit(r)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = Engine(cfg, scfg, params=params, device="cuda")
    reqs = _requests(rng, cfg.vocab_size, LM_REQUESTS, 8, 200,
                     LM_MAX_NEW)
    probe = {}

    def snapshot(e):
        """Copies of what the probe step's batched decode reads, and for
        each active slot its request and the index of the token the step
        will emit."""
        if e.decode_steps == LM_PROBE_STEP:
            mask = e.active.copy()
            probe.update(tokens=e.last_tokens.clone(),
                         lengths=e.lengths.copy(), mask=mask,
                         cache=_copy_cache(e.cache),
                         emits=[(e.slot_req[s], len(e.slot_req[s].generated))
                                for s in np.nonzero(mask)[0]])

    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(before_decode=snapshot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(all(r.done and len(r.generated) == LM_MAX_NEW for r in reqs),
          f"lm serve: {sum(r.done for r in reqs)}/{len(reqs)} done, tokens "
          f"{sorted({len(r.generated) for r in reqs})}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "lm serve: a token outside the vocabulary")
    steps = eng.decode_steps
    check(counts["decode_attn"] == cfg.num_layers * steps,
          f"decode_attn: {counts['decode_attn']} launches for {steps} decode "
          f"steps, expected {cfg.num_layers} per step")
    check(bool(probe), f"the run ended before decode step {LM_PROBE_STEP}")

    # the probe step again, on copies of its cache: kernel 5, then plain;
    # the launch counts show which attention each re-run took
    def logits_of(cache):
        return eng.decode(probe["tokens"], probe["lengths"], cache)

    def kernel5_launches():
        return dec_ops.launch_counts()["decode_attn"]

    n0 = kernel5_launches()
    kern = logits_of(_copy_cache(probe["cache"]))
    n1 = kernel5_launches()
    real = flash.decode_attention
    flash.decode_attention = lambda q, k, v, length: \
        dec_ops.decode_attention(q, k, v, length, pallas=False)
    try:
        plain = logits_of(probe["cache"])
    finally:
        flash.decode_attention = real
    n2 = kernel5_launches()
    check(n1 - n0 == cfg.num_layers and n2 == n1, f"lm probe: kernel 5 ran "
          f"{n1 - n0} times in the kernel re-run and {n2 - n1} in the plain "
          f"one; expected {cfg.num_layers} and 0")
    torch.cuda.synchronize()
    act = torch.as_tensor(probe["mask"], device="cuda")
    kern, plain = kern[act], plain[act]
    check(bool(torch.isfinite(kern).all()) and kern.shape[-1]
          == cfg.vocab_size, "lm probe: logits malformed")
    dmax = float((kern - plain).abs().max())
    lmax = float(plain.abs().max())
    emitted = np.array([req.generated[i] for req, i in probe["emits"]])
    same = int((kern.argmax(-1).cpu().numpy() == emitted).sum())
    print(f"lm probe step {LM_PROBE_STEP}: {int(probe['mask'].sum())} active "
          f"slots | kernel-5 vs plain decode logits max|d| {dmax:.3e} "
          f"(max|logit| {lmax:.3e}, rel {dmax / lmax:.3e}, tol {TOL_LM:g}) | "
          f"argmax = emitted token on {same}/{len(emitted)} slots")
    check(dmax <= TOL_LM * lmax, f"lm probe: kernel-5 logits off the plain "
          f"version's: {dmax} > {TOL_LM} * {lmax}")
    check(same == len(emitted), "lm probe: the re-run step's argmax is not "
          "the token the engine emitted")

    # where a decode step's time goes: the probe step re-run on its cache
    # copy, its wall time untraced and its device busy time traced; the
    # served steps' mean host time beside it
    step_ms = eng.decode_seconds / steps * 1e3
    probe_ms, busy_ms, events, kernel5_ms, top = profile_decode(
        torch, lambda: logits_of(probe["cache"]))
    if busy_ms is None:
        idle = None
        print(f"lm decode step: {step_ms:.3f} ms host time a served step, "
              f"{probe_ms:.3f} ms the probe step | the profiler trace holds"
              " no device events; device busy time not measured")
    else:
        idle = 1.0 - busy_ms / probe_ms
        print(f"lm decode step: {step_ms:.3f} ms host time a served step "
              f"(mean) | probe step {probe_ms:.3f} ms wall, device busy "
              f"{busy_ms:.3f} ms in {events:.0f} device events (profiled), "
              f"kernel 5 {kernel5_ms:.4f} ms of it | device idle share of "
              f"the probe step {idle:.4f} | top: "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in top))

    # a reduced model: the card's greedy tokens are the CPU engine's
    small = get_config(LM_ARCH).reduced()
    sp = lm.init(1, small, device="cpu")
    prompts = [r.prompt[:20] for r in reqs[:5]]
    toks = {}
    for dev in ("cpu", "cuda"):
        e = Engine(small, ServeConfig(max_batch=3, max_len=64,
                                      prefill_bucket=16),
                   params=lm.to_device(sp, dev), device=dev)
        rs = [Request(prompt=[t % small.vocab_size for t in p], max_new=6)
              for p in prompts]
        for r in rs:
            e.submit(r)
        e.run_until_done()
        toks[dev] = [r.generated for r in rs]
    check(toks["cpu"] == toks["cuda"], "reduced smollm-360m: the card's "
          "greedy tokens differ from the CPU engine's")

    lat = eng.latency.percentiles_ms()
    return {"arch": LM_ARCH, "completed": sum(r.done for r in reqs),
            "tokens": eng.tokens_generated, "decode_steps": steps,
            "decode_tokens_per_s": eng.decode_tokens_per_s,
            "wall_tokens_per_s": eng.tokens_generated / wall,
            "wall_s": wall, "decode_s": eng.decode_seconds,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "peak_mem_bytes": peak, "launches": counts,
            "init_s": init_s, "probe_max_abs": dmax, "probe_max_logit": lmax,
            "step_ms": step_ms, "probe_step_ms": probe_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_events_per_step": events, "device_idle_share": idle,
            "kernel5_ms_per_step": kernel5_ms,
            "prompt_lengths": [len(r.prompt) for r in reqs]}


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
    cfg_bfp = dataclasses.replace(cfg, fc_bfp=True, conv_bfp=True)
    params = alexnet.init(0, cfg, device="cuda")
    rows = phase_kernels(torch, np, cfg, params)
    rows_bfp_slabs = phase_kernels(torch, np, cfg_bfp, params)
    rows["bfp_matmul"] = phase_bfp(torch, np, cfg_bfp, params)
    serves = {"f32": phase_serve(torch, np, cfg, params),
              "bfp": phase_serve(torch, np, cfg_bfp, params, cfg_f32=cfg)}
    del params
    torch.cuda.empty_cache()
    rows["decode_attn"] = phase_decode(torch, np)
    lm_serve = phase_lm(torch, np)
    # each path's launches, counted from 0 over its own serve run
    paths = {**{path: sv["launches"] for path, sv in serves.items()},
             "lm": lm_serve["launches"]}

    replaces = {"conv_direct": "src/repro/kernels/conv/direct.py:189",
                "conv_winograd": "src/repro/kernels/conv/winograd.py:297",
                "conv_winograd_fused":
                    "src/repro/kernels/conv/winograd.py:344",
                "bfp_matmul":
                    "src/repro/kernels/bfp_matmul/bfp_matmul.py:29",
                "decode_attn":
                    "src/repro/kernels/decode_attn/decode_attn.py:26"}
    sources = {"conv_direct": "src/repro_torch/csrc/conv_direct.cu",
               "conv_winograd": "src/repro_torch/csrc/conv_winograd.cu",
               "conv_winograd_fused": "src/repro_torch/csrc/conv_winograd.cu",
               "bfp_matmul": "src/repro_torch/csrc/bfp_matmul.cu",
               "decode_attn": "src/repro_torch/csrc/decode_attn.cu"}
    # launches: the serve run of the slice that ported the kernel (the conv
    # kernels f32 AlexNet, kernel 4 BFP AlexNet, kernel 5 the LM);
    # launches_by_path: every run
    home = {"bfp_matmul": "bfp", "decode_attn": "lm"}
    kernels = []
    for kname, row in rows.items():
        if kname == "decode_attn":
            bound_by, extra = row["bound_by"], {
                "geometries": row["geometries"]}
        else:
            peak = (PEAK_INT8_OPS if kname == "bfp_matmul"
                    else PEAK_FP32_FLOPS)
            bound_by = ("operations" if row["flop"] / peak
                        >= row["bytes"] / PEAK_BYTES_PER_S else "bytes")
            extra = {"layers": row["layers"]}
        entry = {
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname],
            "launches": paths[home.get(kname, "f32")][kname],
            "launches_by_path": {path: counts[kname]
                                 for path, counts in paths.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": bound_by, "library_ms": row["library_ms"], **extra}
        if kname in rows_bfp_slabs:
            entry["max_abs_err_bfp_slabs"] = \
                rows_bfp_slabs[kname]["max_abs_err"]
            entry["ms_bfp_slabs"] = rows_bfp_slabs[kname]["ms"]
        kernels.append(entry)
    for name, serve in serves.items():
        print(f"serve {name}: {serve['completed']}/{sum(ARRIVALS)} over "
              f"{serve['batches']} batches {serve['bucket_counts']} | "
              f"{serve['imgs_per_s']:.2f} img/s p50 {serve['p50_ms']:.3f} ms"
              f" p99 {serve['p99_ms']:.3f} ms peak mem "
              f"{serve['peak_mem_bytes'] / 2 ** 20:.1f} MiB | launches "
              f"{serve['launches']} | on {card}")
    print(f"serve lm {LM_ARCH}: {lm_serve['completed']}/{LM_REQUESTS} "
          f"requests, {lm_serve['tokens']} tokens over "
          f"{lm_serve['decode_steps']} decode steps | "
          f"{lm_serve['decode_tokens_per_s']:.2f} tok/s in decode, "
          f"{lm_serve['wall_tokens_per_s']:.2f} tok/s wall | p50 "
          f"{lm_serve['p50_ms']:.3f} ms p99 {lm_serve['p99_ms']:.3f} ms | "
          f"peak mem {lm_serve['peak_mem_bytes'] / 2 ** 20:.1f} MiB | "
          f"launches {lm_serve['launches']} | on {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "serve": serves,
                       "lm_serve": lm_serve,
                       "per_layer": {k: r["per_layer"]
                                     for k, r in rows.items()
                                     if "per_layer" in r},
                       "per_layer_bfp_slabs": {
                           k: r["per_layer"]
                           for k, r in rows_bfp_slabs.items()},
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
