"""Design-space exploration with analytical models (paper §4, eq. 2-7).

Two halves:

1. **The paper's FPGA model**: equations 2-7 as printed, with AlexNet's
   layer dimensions and the Arria 10 GX 1150's resources.  It reproduces
   Fig. 8 (throughput over C_vec x K_vec, optimum at 8x48), Table 2
   (per-layer DSP efficiency) and the 1,020 img/s headline (Fig. 9
   applies the paper's measured 16% system overhead).  Its constants are
   the paper's device's; it is the reproduction baseline, the reference's
   part 1 unchanged.

2. **The card's cost model**: the same method on a GPU: closed-form
   compute / HBM / link time for LM train, prefill and decode cells over
   a (data, model) mesh, grid-searched over the free knobs.  The formulas
   are the reference's; the rates come from a :class:`Hardware` record
   (``H100_SXM`` by default).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterable

from .roofline import H100_SXM, Hardware
from .winograd import winograd_transform

# ---------------------------------------------------------------------------
# 1. Paper-faithful model (eq. 2-7)
# ---------------------------------------------------------------------------
# AlexNet (Krizhevsky) conv dims incl. groups (conv2/4/5 are 2-group convs)
ALEXNET_CONV = [
    # name   C    K    P   Q   R   S  stride groups
    ("conv1", 3, 96, 55, 55, 11, 11, 4, 1),
    ("conv2", 96, 256, 27, 27, 5, 5, 1, 2),
    ("conv3", 256, 384, 13, 13, 3, 3, 1, 1),
    ("conv4", 384, 384, 13, 13, 3, 3, 1, 2),
    ("conv5", 384, 256, 13, 13, 3, 3, 1, 2),
]
ALEXNET_FC = [
    # name    C(in)  K(out)
    ("fc6", 9216, 4096),
    ("fc7", 4096, 4096),
    ("fc8", 4096, 1000),
]
# feature map sizes feeding each conv layer (for stream buffer M20K model)
ALEXNET_FEATURES = [
    ("conv1", 3, 227, 227, 96, 55, 55),
    ("conv2", 96, 27, 27, 256, 27, 27),
    ("conv3", 256, 13, 13, 384, 13, 13),
    ("conv4", 384, 13, 13, 384, 13, 13),
    ("conv5", 384, 13, 13, 256, 13, 13),
]

A10_1150_DSPS = 1518
A10_1150_M20K = 2713


@dataclass(frozen=True)
class DLAConfig:
    c_vec: int = 8
    k_vec: int = 48
    q_vec: int = 4
    w_vec: int = 6
    l_w: int = 1
    l_h: int = 3
    fmax_hz: float = 303e6
    winograd: bool = True
    s_batch: int | None = None        # None -> K_vec * 2 (paper)
    ddr_bytes_per_cycle: float = 64.0


def n_dsps(cfg: DLAConfig) -> float:
    """Equation 2 (+ Winograd halving with the +200 constant)."""
    base = ((cfg.w_vec - cfg.q_vec + 1) * cfg.q_vec * cfg.k_vec
            * cfg.c_vec * 0.5)
    return base / 2 + 200 if cfg.winograd else base


def n_m20k_stream(cfg: DLAConfig, features=ALEXNET_FEATURES) -> float:
    """Equation 3: stream-buffer M20Ks for the worst layer."""
    n_banks = cfg.w_vec * cfg.c_vec
    worst = 0.0
    for (_, c, h, w, k, p, q) in features:
        depth_in = c * h * w / n_banks
        depth_out = k * p * q / n_banks
        worst = max(worst, depth_in + depth_out)
    return math.ceil(worst / (512 * 2)) * n_banks


def n_m20k_filter(cfg: DLAConfig) -> float:
    """Equation 4: filter-cache M20Ks."""
    return cfg.w_vec * cfg.c_vec * cfg.k_vec / 2


S_VEC = 3   # filter-tap vector width of the F(4,3) engine (W_vec = S_vec+Q_vec-1)


def _quant(x: int, step: int) -> float:
    """x useful slots out of ceil(x/step)*step provisioned."""
    return x / (math.ceil(x / step) * step)


def dsp_efficiency(layer, cfg: DLAConfig) -> float:
    """Equation 5's DSP_eff, extended with the quantization terms the paper
    applies implicitly (K tiling on K_vec, 5x5 taps on S_vec=3 chunks, conv1
    input folding): Q/P terms are the printed equation; the others are
    required to reproduce Table 2 (e.g. conv5 = 62.6%).
    """
    name, c, k, p, q, r, s, stride, groups = layer
    cg = c // groups
    qe = _quant(q, cfg.q_vec * cfg.l_w)
    pe = _quant(p, cfg.l_h)
    ke = _quant(k, cfg.k_vec)
    if name == "conv1":
        # paper folds 3 input maps x 11 taps into C_vec*S_vec-wide chunks
        taps = cg * r * s
        cse = _quant(taps, cfg.c_vec * S_VEC)
    else:
        cse = _quant(s, S_VEC) * _quant(cg, cfg.c_vec)
    return qe * pe * ke * cse


def _wino_mults_per_cycle(cfg: DLAConfig) -> float:
    """Winograd-domain multiplies per cycle: K_vec PEs x W_vec dot units x
    C_vec lanes (paper: 48*6*8 = 2304 @ 8x48)."""
    return cfg.k_vec * cfg.w_vec * cfg.c_vec


def conv_cycles(layer, nxt, cfg: DLAConfig) -> dict:
    """Equation 5 for one conv layer; ``nxt`` is the next conv layer whose
    filters are prefetched during this one (None for the last)."""
    name, c, k, p, q, r, s, stride, groups = layer
    eff = dsp_efficiency(layer, cfg)
    macs = k * (c // groups) * q * p * r * s
    n_mult = macs / 2 if cfg.winograd else macs   # F(4,3): 12 MACs -> 6 mults
    n_cycles = n_mult / (_wino_mults_per_cycle(cfg) * eff)
    if nxt is not None:
        _, cn, kn, _, _, rn, sn, _, gn = nxt
        byte_req = kn * rn * sn * (cn // gn) * 2
    else:
        byte_req = 0.0
    byte_ddr = cfg.ddr_bytes_per_cycle * n_cycles
    n_real = n_cycles * max(1.0, byte_req / byte_ddr) if byte_ddr else n_cycles
    return {"name": name, "cycles": n_real, "ideal_cycles": n_cycles,
            "dsp_eff": eff, "flops": 2 * macs, "winograd": cfg.winograd}


def fc_cycles(layer, cfg: DLAConfig) -> dict:
    """Equation 6 for one FC layer (whole batch); no Winograd, engine runs
    K_vec*W_vec*C_vec MACs/cycle with features cached / filters streamed."""
    name, c, k = layer
    s_batch = cfg.s_batch or cfg.k_vec * 2
    macs = k * c * s_batch
    n_cycles = macs / _wino_mults_per_cycle(cfg)
    byte_req = c * k * 2
    byte_ddr = cfg.ddr_bytes_per_cycle * n_cycles
    n_real = n_cycles * max(1.0, byte_req / byte_ddr)
    return {"name": name, "cycles": n_real, "ideal_cycles": n_cycles,
            "flops": 2 * macs, "s_batch": s_batch}


def alexnet_throughput(cfg: DLAConfig, *, system_overhead: float = 0.0) -> dict:
    """Equation 7: img/s for AlexNet + per-layer detail (Table 2 analog)."""
    convs = [conv_cycles(ALEXNET_CONV[i],
                         ALEXNET_CONV[i + 1] if i + 1 < len(ALEXNET_CONV) else None,
                         cfg)
             for i in range(len(ALEXNET_CONV))]
    fcs = [fc_cycles(l, cfg) for l in ALEXNET_FC]
    s_batch = cfg.s_batch or cfg.k_vec * 2
    total_cycles = (sum(c["cycles"] for c in convs)
                    + sum(f["cycles"] / s_batch for f in fcs))
    img_s = cfg.fmax_hz / total_cycles * (1.0 - system_overhead)
    flops_per_img = (sum(c["flops"] for c in convs)
                     + sum(f["flops"] / f["s_batch"] for f in fcs))
    # per-layer achieved GFLOPS at this throughput (actual; effective = *2 for
    # winograd layers)
    layers = []
    for c in convs:
        gf = c["flops"] * cfg.fmax_hz / c["cycles"] / 1e9
        layers.append({"name": c["name"], "act_gflops": gf / (2 if c["winograd"] else 1),
                       "eff_gflops": gf if c["winograd"] else gf,
                       "dsp_eff": c["dsp_eff"]})
    for f in fcs:
        gf = f["flops"] * cfg.fmax_hz / f["cycles"] / 1e9
        layers.append({"name": f["name"], "act_gflops": gf, "eff_gflops": gf,
                       "dsp_eff": f["ideal_cycles"] / f["cycles"]})
    return {"img_per_s": img_s, "total_cycles": total_cycles,
            "gflops_per_img": flops_per_img / 1e9, "layers": layers,
            "effective_gflops": flops_per_img * img_s / 1e9}


def fits_device(cfg: DLAConfig, dsps=A10_1150_DSPS, m20ks=A10_1150_M20K) -> bool:
    return (n_dsps(cfg) <= dsps and
            n_m20k_stream(cfg) + n_m20k_filter(cfg) <= m20ks)


def explore_fpga(c_vecs: Iterable[int] = (2, 4, 8, 16),
                 k_vecs: Iterable[int] = tuple(range(8, 129, 8))) -> list:
    """Fig. 8: sweep (C_vec, K_vec), 0 throughput where infeasible/odd."""
    rows = []
    for c in c_vecs:
        for k in k_vecs:
            cfg = DLAConfig(c_vec=c, k_vec=k)
            if k % c != 0 or not fits_device(cfg):
                rows.append({"c_vec": c, "k_vec": k, "img_per_s": 0.0})
                continue
            r = alexnet_throughput(cfg)
            rows.append({"c_vec": c, "k_vec": k, "img_per_s": r["img_per_s"]})
    return rows


# ---------------------------------------------------------------------------
# 2. The card's cost model (same method, the card's resources)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelInput:
    n_active: float          # active matmul params per token
    n_total: float           # total params (streamed bytes in decode)
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode
    d_model: int
    num_layers: int
    cache_bytes_per_token: float = 0.0


def lm_cost(inp: ModelInput, *, data: int, model: int, pod: int = 1,
            dtype_bytes: int = 2, grad_compress: float = 1.0,
            hw: Hardware = H100_SXM) -> dict:
    """Closed-form roofline terms (seconds), the card's analog of eq. 5-7,
    at ``hw``'s bf16 peak, HBM and link rates.

    grad_compress < 1 models BFP-compressed gradient reduce-scatter.
    """
    chips = data * model * pod
    tokens = (inp.global_batch if inp.kind == "decode"
              else inp.seq_len * inp.global_batch)
    mult = 6.0 if inp.kind == "train" else 2.0
    flops = mult * inp.n_active * tokens
    t_compute = flops / (chips * hw.peak_bf16)

    if inp.kind == "decode":
        # weight streaming dominates (paper's FC regime): every step reads
        # all (model-sharded) weights + the KV cache slice
        hbm = (inp.n_total * dtype_bytes / model
               + inp.cache_bytes_per_token * inp.seq_len
               * inp.global_batch / chips)
        t_mem = hbm / hw.hbm_bw
    else:
        # activations + weights per step per device
        act = tokens * inp.d_model * dtype_bytes * inp.num_layers * 4 / chips
        hbm = inp.n_total * dtype_bytes / model + act
        t_mem = hbm / hw.hbm_bw

    # collectives: TP all-reduce of layer outputs (2/layer fwd, 2 bwd) +
    # DP gradient reduce-scatter+all-gather
    act_bytes = tokens * inp.d_model * dtype_bytes / (data * pod)
    tp_coll = (2 * (3 if inp.kind == "train" else 1) * inp.num_layers
               * act_bytes * 2 * (model - 1) / max(model, 1))
    dp_coll = 0.0
    if inp.kind == "train" and data * pod > 1:
        g = data * pod
        dp_coll = (2 * inp.n_total * 4 / model) * (g - 1) / g * grad_compress
    t_coll = (tp_coll + dp_coll) / hw.link_bw
    step = max(t_compute, t_mem, t_coll)
    return {"t_compute": t_compute, "t_memory": t_mem, "t_collective": t_coll,
            "step_time": step,
            "bound": max((("compute", t_compute), ("memory", t_mem),
                          ("collective", t_coll)), key=lambda kv: kv[1])[0],
            "throughput_tokens_s": tokens / step if step else 0.0,
            "mfu": flops / (step * chips * hw.peak_bf16) if step else 0.0}


def explore_gpu(inp: ModelInput, chips: int = 256, pods: int = 1, *,
                hw: Hardware = H100_SXM) -> list[dict]:
    """Sweep (data, model) factorizations: Fig. 8's analog on cards."""
    rows = []
    m = 1
    while m <= chips:
        if chips % m == 0:
            r = lm_cost(inp, data=chips // m, model=m, pod=pods, hw=hw)
            rows.append(dict(r, data=chips // m, model=m))
        m *= 2
    return rows


def decode_batch_curve(inp: ModelInput, *, data: int, model: int,
                       batches=(1, 2, 4, 8, 16, 32, 64, 128, 256),
                       hw: Hardware = H100_SXM) -> list:
    """Paper §3.7 in the decode regime: tokens/s vs batch saturates when
    compute time overtakes weight-streaming time (the FC batching curve,
    eq. 6's BYTE_req/BYTE_ddr crossover)."""
    rows = []
    for b in batches:
        r = lm_cost(dataclasses.replace(inp, global_batch=b), data=data,
                    model=model, hw=hw)
        rows.append(dict(r, batch=b))
    return rows


def winograd_speedup(r: int = 3, m: int = 4) -> float:
    return winograd_transform(m, r).mult_ratio
