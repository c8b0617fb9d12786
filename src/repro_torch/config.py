"""Architecture configuration dataclasses of the LM stack (the reference's
``repro/config.py``).

Every language model is one :class:`ArchConfig`; the model code in
``repro_torch.nn`` / ``repro_torch.models`` is driven entirely by its fields
(the paper's "sequencer" idea, §3.8: one engine, many topologies).  The
fields and defaults are the reference's, so one config means the same in
both packages and :meth:`ArchConfig.reduced` gives the same tiny config.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts sub-config."""

    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    num_shared: int = 0            # always-on shared experts (DeepSeek style)
    period: int = 1                # MoE FFN every `period` layers ...
    offset: int = 0                # ... at layer index `offset` (mod period)
    first_k_dense: int = 0         # first k layers use a dense FFN instead
    group_size: int = 128          # dispatch group length along seq
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    """Mamba-2 SSD sub-config."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    ngroups: int = 1
    chunk: int = 256               # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense-FFN hidden (0 = no FFN sublayer)
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"       # swiglu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None

    # hybrid interleave: attention mixer at layer index `attn_offset` of
    # every `attn_period` layers; all other layers use the SSM mixer
    attn_period: int = 1
    attn_offset: int = 0

    encoder_layers: int = 0        # encoder-decoder (audio family)
    cross_attention: bool = False
    num_patches: int = 0           # vlm: prepended patch embeddings

    dtype: str = "bfloat16"        # activation / compute dtype
    param_dtype: str = "float32"   # parameter storage dtype
    remat: bool = True             # training: recompute each layer in the
    #                                backward (nn/blocks.py)
    remat_policy: str = "nothing"  # or "save_attn": keep the flash output
    logits_softcap: float = 0.0
    banded_attention: bool = False  # lower-triangle flash schedule (causal)
    fc_bfp: bool = False           # stream the untied lm_head as
    #                                shared-exponent int8 BFP (paper §3.6)

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    @property
    def attn_supported_long(self) -> bool:
        """True if the arch can run the 500k-token long-context shape
        (sub-quadratic / constant-state sequence mixing)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        """Encoder-only archs have no decode step; every config here
        decodes."""
        return True

    def pattern_period(self) -> int:
        """Length of the repeating layer pattern."""
        p = self.attn_period
        if self.moe is not None:
            p = p * self.moe.period // math.gcd(p, self.moe.period)
        return p

    def layer_kind(self, i: int) -> Tuple[str, str]:
        """(mixer, ffn) kind of absolute layer ``i``: mixer in {attn, ssm},
        ffn in {mlp, moe, none}."""
        if self.family == "ssm":
            mixer = "ssm"
        elif self.family == "hybrid":
            mixer = ("attn" if self.attn_period > 0
                     and i % self.attn_period == self.attn_offset else "ssm")
        else:
            mixer = "attn"
        if self.d_ff == 0 and self.moe is None:
            ffn = "none"
        elif self.moe is not None and i >= self.moe.first_k_dense and \
                i % self.moe.period == self.moe.offset:
            ffn = "moe"
        else:
            ffn = "mlp" if self.d_ff > 0 else "none"
        return mixer, ffn

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        period = self.pattern_period()
        prefix = self.moe.first_k_dense if self.moe else 0
        kw = dict(
            num_layers=prefix + 2 * period,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 2,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=503,  # deliberately non-round: catches padding bugs
            encoder_layers=2 if self.encoder_layers else 0,
            num_patches=8 if self.num_patches else 0,
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=8,
                                top_k=min(self.moe.top_k, 2), d_ff=64,
                                group_size=16)
        if self.mla is not None:
            kw["mla"] = MLACfg(kv_lora_rank=32, qk_nope_head_dim=16,
                               qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=8, chunk=16)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells of the LM family: seq_len x global_batch (the
# reference's; ``model_flops_estimate`` counts a step's work at one)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and the reason if not."""
    if shape.name == "long_500k" and not arch.attn_supported_long:
        return False, ("full-attention arch: 500k decode needs a "
                       "sub-quadratic mixer")
    return True, ""
