#!/usr/bin/env python3
"""Kernel 7 (the depthwise causal conv) with its rows staged in shared
memory by ``cp.async``, as ``csrc/dw1d.cu`` has it, against the same
kernel with each lane's rows loaded straight into registers, on the card.

    python3 scripts/probe_dw1d_registers.py [--out probe.json]

Builds ``scripts/dw1d_register_probe.cu`` with ``nvcc`` into
``build/dw1d_register_probe/`` and times both at ``chip_smoke.py``'s
phase-7 geometries (``DW1D_GEOMETRIES``) for every count of Winograd tiles
a block (kernel 7's ``DW1D_TILES``; the register variant also 8), beside
the stream floor (a bare read and write of x's bytes,
``chip_smoke.stream_copy``).  Both must give kernel 7's bits.  Every time
is ``chip_smoke.time_ms``'s: device ms a call, L2 flushed, mean of 20.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "scripts", "dw1d_register_probe.cu")
OUT_DIR = os.path.join(ROOT, "build", "dw1d_register_probe")
REGISTER_TILES = (1, 2, 4, 8)


def build_probe():
    from repro_torch.kernels import build
    os.makedirs(OUT_DIR, exist_ok=True)
    lib_path = os.path.join(OUT_DIR, "dw1d_register_probe.so")
    done = subprocess.run(
        [build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", "-Xptxas", "-v", SOURCE, "-o", lib_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise build.KernelError(f"nvcc failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_dw1d_regs.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.probe_dw1d_regs.restype = i
    return lib, done.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_dw1d_registers: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels.conv import winograd as wino
    card = chip_smoke.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    lib, ptxas = build_probe()
    print("\n".join(line for line in ptxas.splitlines()
                    if "registers" in line or "spill" in line))
    mats = wino._dw1d_mats()
    rule = wino.dw1d_launch
    rng = np.random.default_rng(5)
    rows, bad = [], []
    for name, B, L, C, dtype_name in chip_smoke.DW1D_GEOMETRIES:
        dtype = getattr(torch, dtype_name)
        x = torch.as_tensor(rng.standard_normal((B, L, C)),
                            dtype=torch.float32, device="cuda").to(dtype)
        w = torch.as_tensor(rng.standard_normal((4, C)) * 0.1,
                            dtype=torch.float32, device="cuda")
        b = torch.as_tensor(rng.standard_normal((C,)) * 0.1,
                            dtype=torch.float32, device="cuda")
        ref = wino.conv1d_depthwise_causal(x, w, b)
        floor_ms, _ = chip_smoke.time_ms(torch, chip_smoke.stream_copy(x))
        out = torch.empty_like(x)

        def registers(t):
            err = lib.probe_dw1d_regs(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), mats.ctypes.data,
                out.data_ptr(), B, L, C, t,
                0 if dtype == torch.float32 else 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe_dw1d_regs: CUDA error {err}")
            return out

        def shared(t):
            wino.dw1d_launch = lambda *shape: t
            try:
                return wino.conv1d_depthwise_causal(x, w, b)
            finally:
                wino.dw1d_launch = rule

        for how, tiles, fn in (("shared", wino.DW1D_TILES, shared),
                               ("registers", REGISTER_TILES, registers)):
            for t in tiles:
                equal = bool(torch.equal(fn(t), ref))
                ms, _ = chip_smoke.time_ms(torch, lambda: fn(t))
                sel = how == "shared" and t == rule(B, L, C)
                rows.append({"geometry": name, "dtype": dtype_name, "L": L,
                             "staging": how, "tiles": t, "picked": sel,
                             "ms": ms, "stream_floor_ms": floor_ms,
                             "bit_equal_to_kernel_7": equal})
                print(f"dw1d {name} {dtype_name} {how} tiles {t}"
                      f"{' (kernel 7)' if sel else ''}: {ms:.4f} ms | stream "
                      f"floor {floor_ms:.4f} | bit-equal to kernel 7 {equal}")
                if not equal:
                    bad.append((name, dtype_name, how, t))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    if bad:
        print(f"probe_dw1d_registers: bits differ at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
