#!/usr/bin/env python3
"""How fast the card reads a weight stream once: loads straight into
registers against a ``cp.async`` ring in shared memory, on the card.

    python3 scripts/probe_weight_stream.py [--out probe.json]

Builds ``scripts/weight_stream_probe.cu`` with ``nvcc`` into
``build/weight_stream_probe/`` and reads an int8 stream of fc8's weight
bytes (4096 x 1000), fc6's (9216 x 4096) and 256 MB once, at launch
shapes around kernel 4's (``csrc/bfp_matmul.cu``): ``ldg`` keeps U 16-byte
loads a thread in flight in registers, ``ring`` streams each block's share
through S stages of 16-byte ``cp.async`` copies.  Beside them, ``torch.sum``
over the same bytes as f32.  Every time is ``chip_smoke.time_ms``'s:
device ms a call, L2 flushed, mean of 20.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "scripts", "weight_stream_probe.cu")
OUT_DIR = os.path.join(ROOT, "build", "weight_stream_probe")
# (name, bytes)
STREAMS = (("fc8", 4096 * 1000), ("fc6", 9216 * 4096),
           ("256 MB", 256 * 2 ** 20))
# (mode, blocks, threads, depth): depth = loads in flight a thread (ldg) or
# ring stages (ring)
LAUNCHES = (("ldg", 1056, 256, 4), ("ldg", 1056, 256, 8),
            ("ldg", 2112, 256, 4), ("ldg", 132, 32, 8), ("ldg", 528, 32, 8),
            ("ldg", 264, 128, 8), ("ring", 128, 256, 4),
            ("ring", 256, 64, 8), ("ring", 128, 32, 8), ("ring", 512, 64, 4),
            ("ring", 1024, 128, 4))
MODES = {"ldg": 0, "ring": 1}


def build_probe():
    from repro_torch.kernels import build
    os.makedirs(OUT_DIR, exist_ok=True)
    lib_path = os.path.join(OUT_DIR, "weight_stream_probe.so")
    done = subprocess.run(
        [build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", "-I", str(build.CSRC), SOURCE, "-o", lib_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise build.KernelError(f"nvcc failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_stream.argtypes = [p, ctypes.c_longlong, p, i, i, i, i, p]
    lib.probe_stream.restype = i
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_weight_stream: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    card = chip_smoke.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    lib = build_probe()
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = []
    for name, nbytes in STREAMS:
        src = torch.randint(-127, 128, (nbytes,), dtype=torch.int8,
                            device="cuda")
        as_f32 = src.view(torch.float32)
        ms, _ = chip_smoke.time_ms(torch, lambda: as_f32.sum())
        rows.append({"stream": name, "bytes": nbytes, "how": "torch.sum f32",
                     "ms": ms, "tb_per_s": nbytes / ms / 1e9})
        print(f"{name} ({nbytes} B) torch.sum f32: {ms:.4f} ms "
              f"{nbytes / ms / 1e9:.2f} TB/s")
        for mode, blocks, threads, depth in LAUNCHES:
            def call():
                err = lib.probe_stream(
                    src.data_ptr(), nbytes, sink.data_ptr(), MODES[mode],
                    blocks, threads, depth,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe_stream: CUDA error {err}")
            ms, _ = chip_smoke.time_ms(torch, call)
            rows.append({"stream": name, "bytes": nbytes, "how": mode,
                         "blocks": blocks, "threads": threads,
                         "depth": depth, "ms": ms,
                         "tb_per_s": nbytes / ms / 1e9})
            print(f"{name} {mode} blocks {blocks} threads {threads} "
                  f"{'U' if mode == 'ldg' else 'stages'} {depth}: "
                  f"{ms:.4f} ms {nbytes / ms / 1e9:.2f} TB/s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
