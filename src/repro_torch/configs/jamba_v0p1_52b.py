"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

32L, attention at layer index 4 of every 8 (HF: attn_layer_period=8,
attn_layer_offset=4); MoE FFN every 2 layers at odd indices (expert period 2,
offset 1), 16 experts top-2, expert d_ff = dense d_ff = 14336.

Deviation (the reference's, kept): Jamba's Mamba-1 layers (d_state 16) are
modeled with the SSD (Mamba-2 style) mixer of this framework, head_dim 64.
"""
from repro_torch.config import ArchConfig, MoECfg, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14_336, vocab_size=65_536,
        mlp_type="swiglu", norm_type="rmsnorm",
        attn_period=8, attn_offset=4,
        moe=MoECfg(num_experts=16, top_k=2, d_ff=14_336, period=2, offset=1),
        ssm=SSMCfg(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                   ngroups=1, chunk=256),
    )
