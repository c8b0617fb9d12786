"""Roofline terms on the card: one place for its peaks, the conv-layer
roofline of the paper's Table 2/3 regime, and a model's count of work.

The reference's ``repro/core/roofline.py`` reads its terms off compiled
XLA text (``analyze_hlo``, ``collective_wire_bytes``, ``from_compiled``);
the port counts its own step instead (``core/opcount.py::OpCounter``, on
meta tensors, the dry run's ``launch/dryrun.py``), and
:func:`from_counted` turns such a count into :class:`RooflineTerms`, with
:func:`wire_bytes` the reference's ring factors.  The card's rates come
from a :class:`Hardware` record:

  compute    = FLOPs / (chips * peak FLOP/s of the dtype)
  memory     = HBM bytes / (chips * HBM bytes/s)
  collective = collective bytes / (chips * link bytes/s)
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace


@dataclass(frozen=True)
class Hardware:
    """One card's peak rates: operations a second by dtype (dense),
    memory bytes a second and size, and link bytes a second each way."""
    name: str
    peak_fp32: float
    peak_tf32: float
    peak_bf16: float
    peak_int8: float
    hbm_bw: float
    hbm_bytes: float
    link_bw: float

    def peak(self, dtype: str) -> float:
        """Peak operations a second for ``dtype``: ``float32`` (outside
        the tensor cores), ``tf32``, ``bfloat16`` or ``int8``."""
        return {"float32": self.peak_fp32, "tf32": self.peak_tf32,
                "bfloat16": self.peak_bf16, "int8": self.peak_int8}[dtype]


# NVIDIA H100 SXM (NVIDIA's data sheet: SXM part, dense rates without
# sparsity, at the 700 W power limit); a card set below 700 W runs slower
H100_SXM = Hardware(name="H100 SXM", peak_fp32=67e12, peak_tf32=495e12,
                    peak_bf16=989e12, peak_int8=1.979e15, hbm_bw=3.35e12,
                    hbm_bytes=80e9, link_bw=450e9)

PEAK_FLOPS_BF16 = H100_SXM.peak_bf16
HBM_BW = H100_SXM.hbm_bw
LINK_BW = H100_SXM.link_bw          # NVLink; the reference's ICI_BW


# collective kinds, as the reference's parsers name them
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def wire_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """Wire bytes a device sends for one collective of ``kind`` whose
    result is ``result_bytes`` over a group of ``group_size``, by the
    reference's ring factors (``_line_wire_bytes``): all-gather and
    all-to-all R (g-1)/g, all-reduce 2 R (g-1)/g, reduce-scatter R (g-1),
    collective-permute R."""
    g = group_size
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device (as reported by the partitioned step)
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict = field(default_factory=dict)
    peak_memory_bytes: float = 0.0
    # analytical reference
    model_flops: float = 0.0          # 6*N*D (dense) / 6*N_active*D (MoE)
    hw: Hardware = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_bf16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.hw.link_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global FLOPs (catches remat/redundancy waste)."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def step_time(self) -> float:
        """Roofline step time: max of the three terms (overlap assumed)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of roofline: how close the *useful* work
        comes to peak if the step ran at the modeled step time."""
        if self.step_time == 0 or self.chips == 0:
            return 0.0
        useful_per_dev = self.model_flops / self.chips
        return useful_per_dev / (self.step_time * self.hw.peak_bf16)

    def to_json(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)
             if f.name != "hw"}
        d["coll_breakdown"] = dict(self.coll_breakdown)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bound=self.bound,
                 useful_flops_ratio=self.useful_flops_ratio,
                 step_time=self.step_time,
                 roofline_fraction=self.roofline_fraction,
                 peak_flops=self.hw.peak_bf16, hbm_bw=self.hw.hbm_bw,
                 link_bw=self.hw.link_bw)
        return d


def from_counted(count, *, arch: str, shape: str, mesh: str, chips: int,
                 model_flops: float, memory: dict | None = None,
                 hw: Hardware = H100_SXM) -> RooflineTerms:
    """:class:`RooflineTerms` of one rank's counted step (an
    ``OpCounter``'s ``flops``, ``hbm_bytes`` and ``coll``), the
    counterpart of the reference's ``from_compiled``.  The peak memory is
    ``memory``'s arguments + outputs + temporaries, as there.  The
    reference's ``xla_flops_raw`` and ``xla_bytes_raw`` (XLA's own cost
    analysis) have no counterpart and are left out of
    ``coll_breakdown``."""
    coll = dict(count.coll)
    mem = memory or {}
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_device=float(count.flops),
        hbm_bytes_per_device=float(count.hbm_bytes),
        coll_bytes_per_device=float(sum(coll[k] for k in COLL_KINDS)),
        coll_breakdown=coll,
        peak_memory_bytes=float(mem.get("temp_size", 0)
                                + mem.get("argument_size", 0)
                                + mem.get("output_size", 0)),
        model_flops=model_flops, hw=hw)


# ---------------------------------------------------------------------------
# conv-layer roofline (paper Table 2/3 regime: one fused conv layer)
# ---------------------------------------------------------------------------
@dataclass
class ConvLayerRoofline:
    """Roofline terms for one fused conv layer, weight stream included.

    Memory time counts the modeled *fused* feature-map traffic plus only
    the **exposed** weight bytes: the double-buffered weight stream hides
    ``weight_hidden_bytes`` under compute (the paper's "filters for the
    next layer are prefetched while the current layer is computed").
    ``ai_total`` is the arithmetic intensity over *all* moved bytes;
    ``ai_exposed`` the effective intensity once the prefetch hides the
    steady-state filter stream.  Compute time divides by the peak of
    ``dtype`` (kernels 1-3 compute in FP32 on the H100).
    """
    name: str
    flops: float                    # 2 * MACs for the layer (batch incl.)
    feature_bytes: float            # modeled fused feature-map HBM traffic
    weight_bytes: float             # total filter stream (cache-reused)
    weight_exposed_bytes: float     # fetches not hidden by the prefetch
    weight_prefetch: bool = True
    hw: Hardware = H100_SXM
    dtype: str = "float32"

    @property
    def weight_hidden_bytes(self) -> float:
        return self.weight_bytes - self.weight_exposed_bytes

    @property
    def total_bytes(self) -> float:
        return self.feature_bytes + self.weight_bytes

    @property
    def exposed_bytes(self) -> float:
        return self.feature_bytes + self.weight_exposed_bytes

    @property
    def ai_total(self) -> float:
        return self.flops / self.total_bytes if self.total_bytes else 0.0

    @property
    def ai_exposed(self) -> float:
        return self.flops / self.exposed_bytes if self.exposed_bytes else 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.exposed_bytes / self.hw.hbm_bw

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def to_json(self) -> dict:
        return {
            "name": self.name, "flops": self.flops,
            "feature_bytes": self.feature_bytes,
            "weight_bytes": self.weight_bytes,
            "weight_exposed_bytes": self.weight_exposed_bytes,
            "weight_hidden_bytes": self.weight_hidden_bytes,
            "weight_prefetch": self.weight_prefetch,
            "ai_total": self.ai_total, "ai_exposed": self.ai_exposed,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "bound": self.bound, "dtype": self.dtype,
            "peak_flops": self.hw.peak(self.dtype), "hbm_bw": self.hw.hbm_bw,
        }


def conv_layer_roofline(name: str, hbm: dict, *, flops: float,
                        weight_prefetch: bool = True, hw: Hardware = H100_SXM,
                        dtype: str = "float32") -> ConvLayerRoofline:
    """Build the layer roofline from a ``conv2d_hbm_bytes`` dict.

    ``hbm`` supplies the fused feature-map traffic
    (``layer_fused_bytes``), the filter-cache weight stream
    (``weight_hbm_bytes``), and the prefetch split
    (``weight_exposed_{prefetch,noprefetch}_bytes``); ``flops`` is the
    layer's 2*MACs on its actual datapath (``conv_flops``), batch
    included; ``dtype`` names the peak that bounds it.
    """
    exposed = hbm["weight_exposed_prefetch_bytes" if weight_prefetch
                  else "weight_exposed_noprefetch_bytes"]
    return ConvLayerRoofline(
        name=name, flops=flops,
        feature_bytes=float(hbm["layer_fused_bytes"]),
        weight_bytes=float(hbm["weight_hbm_bytes"]),
        weight_exposed_bytes=float(exposed),
        weight_prefetch=weight_prefetch, hw=hw, dtype=dtype)


def network_conv_roofline(layers: list, *, hw: Hardware = H100_SXM,
                          dtype: str = "float32") -> dict:
    """Whole-network aggregate of :class:`ConvLayerRoofline` terms, its
    compute time at the peak of ``dtype``."""
    flops = sum(l.flops for l in layers)
    feat = sum(l.feature_bytes for l in layers)
    wtot = sum(l.weight_bytes for l in layers)
    wexp = sum(l.weight_exposed_bytes for l in layers)
    t_c = flops / hw.peak(dtype)
    t_m = (feat + wexp) / hw.hbm_bw
    return {
        "flops": flops, "feature_bytes": feat, "weight_bytes": wtot,
        "weight_exposed_bytes": wexp, "weight_hidden_bytes": wtot - wexp,
        "ai_total": flops / (feat + wtot) if feat + wtot else 0.0,
        "ai_exposed": flops / (feat + wexp) if feat + wexp else 0.0,
        "t_compute": t_c, "t_memory": t_m,
        "bound": "compute" if t_c >= t_m else "memory",
        "dtype": dtype, "peak_flops": hw.peak(dtype), "hbm_bw": hw.hbm_bw,
    }


# ---------------------------------------------------------------------------
# a model's work: what a step must compute, whatever code computes it
# ---------------------------------------------------------------------------
def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for a training step, 2*N*D for a forward, N the active
    matmul parameters (:func:`active_param_count`) and D the tokens of
    ``shape`` (a ``ShapeCfg``; decode: one token per sequence)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def active_param_count(cfg) -> float:
    """Analytical active (per-token) matmul parameter count."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    total = V * d  # embedding (readout counted below if untied)
    if not cfg.tie_embeddings:
        total += V * d
    for i in range(L):
        mixer, ffn = cfg.layer_kind(i)
        if mixer == "attn":
            if cfg.mla is not None:
                m = cfg.mla
                H = cfg.num_heads
                total += d * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                total += H * m.v_head_dim * d
            else:
                hd, H, KV = cfg.d_head, cfg.num_heads, cfg.num_kv_heads
                total += d * hd * (H + 2 * KV) + H * hd * d
        else:
            s = cfg.ssm
            di, G, N, Hs = cfg.d_inner, s.ngroups, s.d_state, cfg.ssm_heads
            total += d * (2 * di + 2 * G * N + Hs) + di * d
        if ffn == "mlp":
            mult = 3 if cfg.mlp_type == "swiglu" else 2
            total += mult * d * cfg.d_ff
        elif ffn == "moe":
            mo = cfg.moe
            total += d * mo.num_experts  # router
            total += 3 * d * mo.d_ff * (mo.top_k + mo.num_shared)
    if cfg.encoder_layers:
        hd, H = cfg.d_head, cfg.num_heads
        per_enc = d * hd * H * 4 + 2 * d * cfg.d_ff
        total += cfg.encoder_layers * per_enc
        # decoder cross-attention
        total += cfg.num_layers * (d * hd * H * 4)
    return float(total)


def total_param_count(cfg) -> float:
    """:func:`active_param_count` with every routed expert counted: the
    matmul parameters a step that reads all experts streams."""
    if cfg.moe is None:
        return active_param_count(cfg)
    return active_param_count(replace(
        cfg, moe=replace(cfg.moe, top_k=cfg.moe.num_experts)))
