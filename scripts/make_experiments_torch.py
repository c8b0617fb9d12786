"""The dry run's tables from the port's dry-run JSONL (the twin of
``scripts/make_experiments.py`` for ``repro_torch.launch.dryrun``): one of
each cell's counts and memory, one of the roofline terms (an arch a row,
a shape a column), modelled from ``repro_torch.core.roofline.H100_SXM``'s
data-sheet peaks.

    PYTHONPATH=src python scripts/make_experiments_torch.py \\
        results/dryrun_torch.jsonl [--before OTHER.jsonl]

``--before`` prints two more tables: each cell of both files, before (the
other file's record) and after (this one's), side by side; the second by
collective (all-gather, reduce-scatter, the count inside the layers) and
arguments.
"""
import json
import os
import sys
from collections import OrderedDict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.roofline import H100_SXM     # noqa: E402

HW = (f"{H100_SXM.name} data sheet at 700 W: "
      f"{H100_SXM.peak_bf16 / 1e12:.0f} TFLOP/s bf16, "
      f"{H100_SXM.hbm_bw / 1e12:.2f} TB/s HBM, "
      f"{H100_SXM.link_bw / 1e9:.0f} GB/s NVLink")


def load(path):
    recs = OrderedDict()
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(recs):
    out = ["| arch | shape | mesh | status | count s | args GiB/dev | "
           "temp GiB/dev | flops/dev | HBM bytes/dev | coll bytes/dev | "
           "#colls (in-loop) | ops | launches |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    skipped = {}
    for (a, s, m), r in recs.items():
        if r["status"] == "skipped":
            skipped.setdefault(r["reason"], []).append(f"{a} {s} {m}")
            continue
        if r["status"] != "ok":
            out.append(f"| {a} | {s} | {m} | {r['status']}: "
                       f"{r.get('error', '')[:60]} | | | | | | | | | |")
            continue
        t = r["roofline"]
        cb = t["coll_breakdown"]
        launches = ", ".join(f"{k} {v}" for k, v in
                             sorted(r.get("launches", {}).items())) or "-"
        out.append(
            f"| {a} | {s} | {m} | ok | {r['t_count_s']} "
            f"| {fmt_bytes(r['memory']['argument_size'])} "
            f"| {fmt_bytes(r['memory']['temp_size'])} "
            f"| {t['flops_per_device']:.2e} "
            f"| {t['hbm_bytes_per_device']:.2e} "
            f"| {t['coll_bytes_per_device']:.2e} "
            f"| {cb.get('count', 0)} ({cb.get('in_loop_count', 0)}) "
            f"| {r['ops']} | {launches} |")
    for why, cells in skipped.items():
        out.append(f"\nSkipped ({why}): {', '.join(cells)}.")
    return "\n".join(out)


def roofline_table(recs):
    """One row an (arch, mesh), one column a shape: t_compute / t_memory
    / t_collective in ms, the bound, and the useful share of the counted
    FLOPs."""
    shapes = list(dict.fromkeys(s for _, s, _ in recs))
    rows = list(dict.fromkeys((a, m) for a, _, m in recs))
    out = ["| arch | mesh | " + " | ".join(shapes) + " |",
           "|---|---|" + "---|" * len(shapes)]
    for a, m in rows:
        cells = []
        for s in shapes:
            r = recs.get((a, s, m))
            if r is None or r["status"] != "ok":
                cells.append(r["status"] if r else "")
                continue
            t = r["roofline"]
            cells.append(f"{t['t_compute']*1e3:.4g} / {t['t_memory']*1e3:.4g}"
                         f" / {t['t_collective']*1e3:.4g} **{t['bound']}**"
                         f" {t['useful_flops_ratio']*100:.2f}%")
        out.append(f"| {a} | {m} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def _terms(r):
    t, mem = r["roofline"], r["memory"]
    return (t["flops_per_device"], (mem["argument_size"]
                                    + mem["temp_size"]) / 2 ** 30,
            t["coll_bytes_per_device"], t["useful_flops_ratio"],
            t["bound"])


def before_after_table(before, after):
    """One row a cell ok in both: FLOPs, arguments + temporaries GiB,
    collective wire bytes, ``useful_flops_ratio`` and the bound a rank,
    before -> after."""
    out = ["| arch | shape | mesh | flops/dev | args+temp GiB/dev | "
           "coll bytes/dev | useful | bound |",
           "|---|---|---|---|---|---|---|---|"]
    for key, r in after.items():
        b = before.get(key)
        if r["status"] != "ok" or b is None or b["status"] != "ok":
            continue
        (f0, m0, c0, u0, b0), (f1, m1, c1, u1, b1) = _terms(b), _terms(r)
        out.append(f"| {key[0]} | {key[1]} | {key[2]} | {f0:.2e} -> "
                   f"{f1:.2e} | {m0:.2f} -> {m1:.2f} | {c0:.2e} -> "
                   f"{c1:.2e} | {u0 * 100:.2f}% -> {u1 * 100:.2f}% | "
                   f"{b0} -> {b1} |")
    return "\n".join(out)


def collectives_table(before, after):
    """One row a cell ok in both: the all-gather and reduce-scatter wire
    GB a rank, the collectives issued inside the layers and in all, and
    the arguments GiB a rank, before -> after."""
    out = ["| arch | shape | mesh | all-gather GB/dev | reduce-scatter "
           "GB/dev | in-loop (all) collectives | args GiB/dev |",
           "|---|---|---|---|---|---|---|"]
    for key, r in after.items():
        b = before.get(key)
        if r["status"] != "ok" or b is None or b["status"] != "ok":
            continue
        c0, c1 = (x["roofline"]["coll_breakdown"] for x in (b, r))
        out.append(
            f"| {key[0]} | {key[1]} | {key[2]} | "
            f"{c0['all-gather'] / 1e9:.3f} -> {c1['all-gather'] / 1e9:.3f} "
            f"| {c0['reduce-scatter'] / 1e9:.3f} -> "
            f"{c1['reduce-scatter'] / 1e9:.3f} | {c0['in_loop_count']} "
            f"({c0['count']}) -> {c1['in_loop_count']} ({c1['count']}) | "
            f"{fmt_bytes(b['memory']['argument_size'])} -> "
            f"{fmt_bytes(r['memory']['argument_size'])} |")
    return "\n".join(out)


def main(path, before=None):
    recs = load(path)
    ok = sum(1 for r in recs.values() if r["status"] == "ok")
    sk = sum(1 for r in recs.values() if r["status"] == "skipped")
    er = len(recs) - ok - sk
    print("## Dry run (the port)\n")
    print(f"Modelled, {HW}; counted on meta tensors, no card time.  "
          f"Meshes: 16x16 (256 ranks) and 2x16x16 (512 ranks) of a fake "
          f"world.  Cells: {ok} ok, {sk} skipped, {er} errors.\n")
    print(dryrun_table(recs))
    print("\n## Roofline (the port)\n")
    print("Each cell: t_compute / t_memory / t_collective in ms (counted "
          "FLOPs / bf16 peak, HBM bytes / HBM rate, wire bytes / NVLink "
          "rate, one rank's), the bound, and MODEL_FLOPS over the counted "
          "FLOPs of all ranks.\n")
    print(roofline_table(recs))
    if before is not None:
        print(f"\n## Before ({before}) -> after ({path})\n")
        print(before_after_table(load(before), recs))
        print(f"\n## Collectives, before ({before}) -> after ({path})\n")
        print(collectives_table(load(before), recs))


if __name__ == "__main__":
    args = sys.argv[1:]
    prior = None
    if "--before" in args:
        i = args.index("--before")
        prior = args[i + 1]
        del args[i:i + 2]
    main(args[0] if args else "results/dryrun_torch.jsonl", prior)
