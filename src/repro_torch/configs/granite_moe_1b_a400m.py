"""granite-moe-1b-a400m [moe] — 32 experts top-8, every layer MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.config import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49_155,
        mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=True,
        moe=MoECfg(num_experts=32, top_k=8, d_ff=512, period=1, offset=0),
    )
