"""Hill-climbing harness of the port's dry run: count one (arch x shape x
mesh) cell under a named variant (rules / cfg overrides / serve dtype),
print the three roofline terms beside the recorded baseline, and append
the record to results/hillclimb_torch.jsonl (the twin of
``scripts/hillclimb.py`` over ``repro_torch.launch.dryrun``; the terms are
modelled from ``core/roofline.py::H100_SXM``'s data-sheet peaks).

    PYTHONPATH=src python scripts/hillclimb_torch.py \\
        --arch starcoder2-15b --shape train_4k --mesh single \\
        --name banded_attn --cfg '{"banded_attention": true}'
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config        # noqa: E402
from repro_torch.launch.dryrun import run_cell     # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--name", required=True, help="variant name for the log")
    ap.add_argument("--cfg", default="", help="JSON ArchConfig overrides")
    ap.add_argument("--rules", default="", help="JSON sharding-rule overrides")
    ap.add_argument("--serve-dtype", default="bf16")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a quick check)")
    ap.add_argument("--baseline", default="results/dryrun_torch.jsonl")
    ap.add_argument("--out", default="results/hillclimb_torch.jsonl")
    args = ap.parse_args(argv)

    rec = run_cell(args.arch, args.shape,
                   multi_pod=args.mesh == "multi",
                   rules=json.loads(args.rules) if args.rules else None,
                   cfg_overrides=json.loads(args.cfg) if args.cfg else None,
                   serve_dtype=args.serve_dtype,
                   zero1=not args.no_zero1, fsdp=args.fsdp,
                   cfg=get_config(args.arch).reduced() if args.reduced
                   else None)
    rec["variant"] = args.name
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")

    if rec["status"] != "ok":
        print(f"[{rec['status']}] {rec.get('error') or rec.get('reason')}")
        return 1

    t = rec["roofline"]
    mesh_name = rec["mesh"]
    base = None
    try:
        with open(args.baseline) as f:
            for line in f:
                r = json.loads(line)
                if (r["arch"], r["shape"], r["mesh"]) == \
                        (args.arch, args.shape, mesh_name) and \
                        r["status"] == "ok":
                    base = r["roofline"]
    except FileNotFoundError:
        pass

    def row(tag, tt):
        print(f"  {tag:10s} comp={tt['t_compute']*1e3:9.2f}ms "
              f"mem={tt['t_memory']*1e3:9.2f}ms "
              f"coll={tt['t_collective']*1e3:9.2f}ms "
              f"bound={tt['bound']:10s} step={tt['step_time']*1e3:9.2f}ms "
              f"frac={tt['roofline_fraction']*100:5.1f}%")

    print(f"{args.arch} {args.shape} {mesh_name} variant={args.name} "
          "(modelled: H100_SXM data sheet, counted on meta)")
    if base:
        row("baseline", base)
    row("variant", t)
    if base:
        d = base["step_time"] / t["step_time"]
        print(f"  step-time speedup vs baseline: {d:.2f}x  "
              f"temp={rec['memory']['temp_size']/2**30:.2f}GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
