"""Dry run of every (arch x shape x mesh) cell: the port's own step counted
on meta tensors as one rank of a fake world of 256 (16x16) or 512
(2x16x16) ranks (the reference's ``repro/launch/dryrun.py``, which lowers
and compiles each cell on forced host devices and reads XLA's text).

A cell places its stand-ins (``launch/specs.py``) on the production mesh
of a fake world (``launch/mesh.py::init_fake_world``, started and ended by
each :func:`run_cell`) and runs its step once under
``core/opcount.py::OpCounter``: what the card would run, op by op, with
the port's kernels and collectives, nothing allocated and nothing moved.
The record keeps the reference's keys where they mean the same thing
(``arch``, ``shape``, ``mesh``, ``kind``, ``status``, ``reason``,
``chips``, ``memory``, ``roofline``, ``error``, ``traceback``);
``t_lower_s`` is the time to build and place the stand-ins, and the
reference's ``t_compile_s`` and ``hlo_bytes`` are replaced by
``t_count_s`` (the counted run) and ``ops`` (the ops counted); ``launches``
counts the hand-written kernels' launches.  The roofline terms are
modelled from ``core/roofline.py::H100_SXM``'s data-sheet peaks.  A step
that cannot run on meta makes the record ``status: "error"`` with its
traceback; nothing falls back.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from ..config import SHAPES, shape_applicable
from ..configs import LM_ARCHS, get_config
from ..core import roofline as rl

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def apply_cfg_overrides(cfg, overrides: dict | None):
    """dataclasses.replace on ArchConfig; 'moe.x'/'ssm.x' reach
    sub-configs."""
    if not overrides:
        return cfg
    top, nested = {}, {}
    for k, v in overrides.items():
        if "." in k:
            head, tail = k.split(".", 1)
            nested.setdefault(head, {})[tail] = v
        else:
            top[k] = v
    for head, kv in nested.items():
        sub = getattr(cfg, head)
        if sub is not None:
            top[head] = dataclasses.replace(sub, **kv)
    return dataclasses.replace(cfg, **top)


def count_step(step, *args, keep_ops: bool = False, outputs=None):
    """Run ``step(*args)`` once under a fresh ``OpCounter`` (its inputs
    registered as the arguments) -> (counter, the step's result, memory:
    the reference's keys, the outputs being ``outputs(args, result)``, by
    default the result)."""
    from ..core.opcount import OpCounter
    counter = OpCounter(keep_ops=keep_ops)
    with counter:
        counter.arguments(*args)
        result = step(*args)
    outs = result if outputs is None else outputs(args, result)
    return counter, result, counter.memory(outs)


def build_cell(cfg, shape, mesh, *, rules=None, zero1: bool = True,
               fsdp: bool = False, serve_dtype: str = "bf16"):
    """(step, its placed arguments, outputs) of a cell on ``mesh``:
    train -> the state placed by ``state_shardings`` (``fsdp``: the params
    split over "data", gathered per layer) and the global batch;
    prefill/decode -> serving weights placed by ``param_shardings``, the
    batch and the caches placed by ``cache_shardings``."""
    from ..parallel import sharding as shlib
    from . import specs as sp
    with shlib.use_mesh_rules(mesh, rules):
        if shape.kind == "train":
            state = sp.state_specs(cfg)
            state = sp.place_state(state, sp.state_shardings(
                cfg, state, mesh, zero1=zero1, fsdp=fsdp))
            step = sp.make_train_step(cfg, mesh=mesh, rules=rules)
            return (step, (state, sp.batch_specs(cfg, shape)),
                    lambda a, r: (a[0], r))
        params = sp.serve_param_specs(cfg, serve_dtype)
        params = shlib.place_tree(params, shlib.param_shardings(params,
                                                                mesh))
        caches = sp.cache_specs(cfg, shape)
        caches = shlib.place_tree(caches, sp.cache_shardings(cfg, caches,
                                                             mesh))
        step = (sp.make_prefill_step(cfg, mesh=mesh, rules=rules)
                if shape.kind == "prefill" else
                sp.make_decode_step(cfg, shape, mesh=mesh, rules=rules))
        return step, (params, sp.batch_specs(cfg, shape), caches), None


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules: dict | None = None, zero1: bool = True,
             fsdp: bool = False, keep_ops: bool = False,
             serve_dtype: str = "bf16", cfg_overrides: dict | None = None,
             cfg=None, shape=None, mesh_shape=None) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh_shape`` (a
    smaller fake world: (data, model) or (pod, data, model)) stand in for
    ``get_config(arch)``, ``SHAPES[shape_name]`` and the production
    mesh."""
    cfg = apply_cfg_overrides(cfg or get_config(arch), cfg_overrides)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if mesh_shape is None:
        dims, axes = MESHES[multi_pod]
    else:
        dims = tuple(mesh_shape)
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                          "model")
    mesh_name = "x".join(map(str, dims))
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind}
    if not ok:
        return dict(base, status="skipped", reason=why)

    import torch.distributed as dist

    from .mesh import init_fake_world, make_mesh
    chips = math.prod(dims)
    t0 = time.time()
    init_fake_world(chips)
    try:
        mesh = make_mesh(dims, axes, device_type="cpu")
        step, args, outputs = build_cell(cfg, shape, mesh, rules=rules,
                                         zero1=zero1, fsdp=fsdp,
                                         serve_dtype=serve_dtype)
        t_lower = time.time() - t0
        from ..parallel import sharding as shlib
        with shlib.use_mesh_rules(mesh, rules):
            counter, _, memory = count_step(step, *args, keep_ops=keep_ops,
                                            outputs=outputs)
        t_count = time.time() - t0 - t_lower
        terms = rl.from_counted(
            counter, arch=arch, shape=shape_name, mesh=mesh_name,
            chips=chips, model_flops=rl.model_flops_estimate(cfg, shape),
            memory=memory)
        rec = dict(base, status="ok", t_lower_s=round(t_lower, 1),
                   t_count_s=round(t_count, 1), ops=counter.ops,
                   chips=chips, memory=memory,
                   launches=dict(counter.launches),
                   roofline=terms.to_json())
        if keep_ops:
            rec["ops_path"] = _dump_ops(arch, shape_name, mesh_name,
                                        counter.by_op)
        return rec
    except Exception as e:  # a failure here is a fault of the port
        return dict(base, status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])
    finally:
        dist.destroy_process_group()


def _dump_ops(arch, shape_name, mesh_name, by_op) -> str:
    """The per-op count table (op, calls, FLOPs, HBM bytes), heaviest
    bytes first, under ``results/ops/``."""
    d = os.path.join("results", "ops")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, f"{arch}_{shape_name}_{mesh_name}.tsv")
    with open(p, "w") as f:
        f.write("op\tcalls\tflops\thbm_bytes\n")
        for op, (n, fl, nb) in sorted(by_op.items(),
                                      key=lambda kv: -kv[1][2]):
            f.write(f"{op}\t{n}\t{fl:.0f}\t{nb:.0f}\n")
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {LM_ARCHS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--rules", default="",
                    help="JSON dict of logical-axis rule overrides")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--keep-ops", action="store_true",
                    help="write each cell's per-op count table under "
                         "results/ops/")
    ap.add_argument("--serve-dtype", default="bf16",
                    choices=["f32", "bf16", "bfp8"],
                    help="weight stream dtype for prefill/decode cells")
    ap.add_argument("--reduced", action="store_true",
                    help="count each arch's reduced config (a quick check)")
    args = ap.parse_args(argv)

    archs = LM_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rules = json.loads(args.rules) if args.rules else None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_err = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, multi_pod=mp, rules=rules,
                                   keep_ops=args.keep_ops,
                                   serve_dtype=args.serve_dtype,
                                   zero1=not args.no_zero1, fsdp=args.fsdp,
                                   cfg=get_config(arch).reduced()
                                   if args.reduced else None)
                    rec["serve_dtype"] = args.serve_dtype
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    st = rec["status"]
                    n_ok += st == "ok"
                    n_skip += st == "skipped"
                    n_err += st == "error"
                    if st == "ok":
                        r, m = rec["roofline"], rec["memory"]
                        print(f"[{st:7s}] {arch:22s} {shape:12s} "
                              f"{rec['mesh']:8s} "
                              f"count={rec['t_count_s']:6.1f}s "
                              f"bound={r['bound']:10s} "
                              f"step={r['step_time']*1e3:9.2f}ms "
                              f"useful={r['useful_flops_ratio']:.4f} "
                              f"mem/dev={m['argument_size']/2**30:6.2f}+"
                              f"{m['temp_size']/2**30:6.2f}GiB",
                              flush=True)
                    else:
                        print(f"[{st:7s}] {arch:22s} {shape:12s} "
                              f"{rec['mesh']:8s} "
                              f"{rec.get('reason') or rec.get('error', '')}",
                              flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
