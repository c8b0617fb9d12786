#!/usr/bin/env python3
"""Time kernels 4-7 of the PyTorch/CUDA port over their launch
geometries, on the card.

    python3 scripts/sweep_kernel_tiles.py [--out sweep.json] [--only NAME]

Kernel 5 (decode attention, bf16) at ``chip_smoke.py``'s phase-5
geometries and lengths, for each cache-row count a split R; kernel 4 (the
BFP matmul) at fc6-fc8 with M = 8 ReLU-like rows, for each column tile;
kernel 6 (the SSD scan) at phase 7's geometries, for each row tile of y
and state slice (``ssd.ROW_TILES`` x ``ssd.STATE_SLICES``), with each
launch's device ms from a trace (``chip_smoke.stage_ms``); kernel 7 (the
depthwise conv) at phase 7's geometries, for each count of Winograd tiles
a block, beside the stream floor (a bare read and write of x's bytes,
``chip_smoke.stream_copy``).  Each row also names what the wrapper picks
today (``split_rows``, ``tile_cols``, ``row_tile``/``state_slice``,
``dw1d_launch``), and the library call ``chip_smoke.py`` times beside the
kernel (SDPA with the length mask; the f32 FC, TF32 off; ``F.conv1d``).
Kernels 6 and 7 must give the same bits at every setting.  Every time is
``chip_smoke.time_ms``'s: device ms a call, L2 flushed, mean of 20.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_ROWS = (32, 64, 128, 256, 512)
FC_LAYERS = (("fc6", 9216, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 1000))


def sweep_decode(torch, np, chip_smoke):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attn as dec
    picked_rule = dec.split_rows
    rng = np.random.default_rng(3)        # phase 5's draws, in its order
    rows = []
    for name, B, S, H, KV, D, fixed in chip_smoke.DECODE_GEOMETRIES:
        lens = torch.as_tensor(rng.integers(1, S + 1, B) if fixed is None
                               else fixed, dtype=torch.int32, device="cuda")
        q, k, v = (torch.as_tensor(rng.standard_normal(shape),
                                   dtype=torch.bfloat16, device="cuda")
                   for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
        picked = picked_rule(B, S, KV, H // KV, D)
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        lib_ms, _ = chip_smoke.time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True))
        ref = dec.decode_attention(q, k, v, lens).float()
        for R in SPLIT_ROWS:
            if R > max(S, dec.TILE_ROWS) * 2:
                continue
            dec.split_rows = lambda *shape, R=R: R
            try:
                err = float((dec.decode_attention(q, k, v, lens).float()
                             - ref).abs().max())
                ms, host = chip_smoke.time_ms(
                    torch, lambda: dec.decode_attention(q, k, v, lens))
                grid = dec.decode_grid(B, S, KV, H // KV, D)
            finally:
                dec.split_rows = picked_rule
            rows.append({"kernel": "decode_attn", "geometry": name, "R": R,
                         "grid": list(grid), "picked": R == picked,
                         "ms": ms, "host_ms": host, "library_ms": lib_ms,
                         "max_abs_vs_picked": err})
            print(f"decode_attn {name}: R {R} grid {grid}"
                  f"{' (picked)' if R == picked else ''} | kernel_ms "
                  f"{ms:.4f} (host {host:.4f}) library_ms {lib_ms:.4f} | "
                  f"max|d| vs picked {err:.3e}")
    return rows


def sweep_bfp(torch, np, chip_smoke):
    from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp
    from repro_torch.kernels.bfp_matmul.ops import quantize_weights
    from repro_torch.kernels.bfp_matmul.ref import exact_matmul
    picked_rule = bfp.tile_cols
    rng = np.random.default_rng(2)
    rows = []
    for layer, K, N in FC_LAYERS:
        x = torch.relu(torch.as_tensor(rng.standard_normal((8, K)),
                                       dtype=torch.float32, device="cuda"))
        w = torch.as_tensor(rng.standard_normal((K, N)) * K ** -0.5,
                            dtype=torch.float32, device="cuda")
        wq, we = quantize_weights(w, block=32)
        picked = picked_rule(8, N)
        lib_ms, _ = chip_smoke.time_ms(torch, lambda: exact_matmul(x, w))
        plain = bfp.bfp_matmul_plain(x, wq, we, block=32)
        for cols in bfp.TILE_COLS:
            bfp.tile_cols = lambda M, N, cols=cols: cols
            try:
                equal = bool(torch.equal(
                    bfp.bfp_matmul(x, wq, we, block=32), plain))
                ms, host = chip_smoke.time_ms(
                    torch, lambda: bfp.bfp_matmul(x, wq, we, block=32))
            finally:
                bfp.tile_cols = picked_rule
            grid = bfp.bfp_grid(8, N, cols)
            rows.append({"kernel": "bfp_matmul", "layer": layer,
                         "cols": cols, "grid": list(grid),
                         "picked": cols == picked, "ms": ms, "host_ms": host,
                         "library_ms": lib_ms, "bit_equal": equal})
            print(f"bfp_matmul {layer}: cols {cols} grid {grid}"
                  f"{' (picked)' if cols == picked else ''} | kernel_ms "
                  f"{ms:.4f} (host {host:.4f}) library_ms {lib_ms:.4f} | "
                  f"bit-equal to plain {equal}")
    return rows


def sweep_ssd(torch, np, chip_smoke):
    from repro_torch.kernels.ssd import ssd
    rules = ssd.row_tile, ssd.state_slice
    rng = np.random.default_rng(5)
    rows = []
    for name, B, L, H, P, G, N, chunk, dtype_name in \
            chip_smoke.SSD_GEOMETRIES:
        dtype = getattr(torch, dtype_name)
        x, Bm, Cm = (torch.as_tensor(rng.standard_normal(shape),
                                     dtype=torch.float32,
                                     device="cuda").to(dtype)
                     for shape in ((B, L, H, P), (B, L, G, N), (B, L, G, N)))
        dt = torch.as_tensor(rng.uniform(1e-3, 1e-1, (B, L, H)),
                             dtype=torch.float32, device="cuda")
        A = torch.as_tensor(-np.linspace(1.0, 16.0, H), dtype=torch.float32,
                            device="cuda")
        Q = min(chunk, L)
        picked = (rules[0](B, L, H, Q), rules[1](B, L, H, N, Q))

        def call():
            return ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=chunk)
        ref = call()
        for rt in ssd.ROW_TILES:
            # with one chunk the y and state blocks share a launch: one tile
            for ns in ((rt,) if L <= chunk else ssd.STATE_SLICES):
                ssd.row_tile = lambda *shape, rt=rt: rt
                ssd.state_slice = lambda *shape, ns=ns: ns
                try:
                    got = call()
                    equal = bool(torch.equal(got[0], ref[0])
                                 and torch.equal(got[1], ref[1]))
                    ms, host = chip_smoke.time_ms(torch, call)
                    stages = chip_smoke.stage_ms(torch, call,
                                                 chip_smoke.SSD_STAGES)
                finally:
                    ssd.row_tile, ssd.state_slice = rules
                grids = ssd.ssd_grids(B, L, H, P, G, N, Q, rt, ns)
                sel = (rt, ns) == picked
                rows.append({"kernel": "ssd", "geometry": name,
                             "dtype": dtype_name, "L": L, "rows": rt,
                             "state_rows": ns, "grids": grids,
                             "picked": sel, "ms": ms, "host_ms": host,
                             "stages_ms": stages,
                             "bit_equal_to_picked": equal})
                st = ("not traced" if stages is None else " ".join(
                    f"{k.replace('ssd_', '').replace('_kernel', '')} "
                    + ("-" if v is None else f"{v:.4f}")
                    for k, v in stages.items()))
                print(f"ssd {name} {dtype_name}: rows {rt} state rows {ns}"
                      f"{' (picked)' if sel else ''} | kernel_ms {ms:.4f} "
                      f"(host {host:.4f}) | stages ms: {st} | bit-equal to "
                      f"picked {equal}")
    return rows


def sweep_dw1d(torch, np, chip_smoke):
    from repro_torch.kernels.conv import winograd as wino
    rule = wino.dw1d_launch
    rng = np.random.default_rng(5)
    rows = []
    for name, B, L, C, dtype_name in chip_smoke.DW1D_GEOMETRIES:
        dtype = getattr(torch, dtype_name)
        x = torch.as_tensor(rng.standard_normal((B, L, C)),
                            dtype=torch.float32, device="cuda").to(dtype)
        w = torch.as_tensor(rng.standard_normal((4, C)) * 0.1,
                            dtype=torch.float32, device="cuda")
        b = torch.as_tensor(rng.standard_normal((C,)) * 0.1,
                            dtype=torch.float32, device="cuda")
        picked = rule(B, L, C)
        ref = wino.conv1d_depthwise_causal(x, w, b)
        floor_ms, _ = chip_smoke.time_ms(torch, chip_smoke.stream_copy(x))
        for t in wino.DW1D_TILES:
            wino.dw1d_launch = lambda *shape, t=t: t
            try:
                equal = bool(torch.equal(
                    wino.conv1d_depthwise_causal(x, w, b), ref))
                ms, host = chip_smoke.time_ms(
                    torch, lambda: wino.conv1d_depthwise_causal(x, w, b))
            finally:
                wino.dw1d_launch = rule
            grid = wino.dw1d_grid(B, L, C, t)
            sel = t == picked
            rows.append({"kernel": "dw1d", "geometry": name,
                         "dtype": dtype_name, "L": L, "tiles": t,
                         "grid": list(grid), "picked": sel, "ms": ms,
                         "host_ms": host, "stream_floor_ms": floor_ms,
                         "bit_equal_to_picked": equal})
            print(f"dw1d {name} {dtype_name}: tiles {t} grid {grid}"
                  f"{' (picked)' if sel else ''} | kernel_ms {ms:.4f} (host "
                  f"{host:.4f}) stream floor {floor_ms:.4f} | bit-equal to "
                  f"picked {equal}")
    return rows


SWEEPS = {"decode_attn": sweep_decode, "bfp_matmul": sweep_bfp,
          "ssd": sweep_ssd, "dw1d": sweep_dw1d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--only", choices=sorted(SWEEPS), action="append",
                    help="sweep only this kernel (repeatable)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_kernel_tiles: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    card = chip_smoke.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    build.library()
    rows = []
    for name, sweep in SWEEPS.items():
        if not args.only or name in args.only:
            rows += sweep(torch, np, chip_smoke)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
