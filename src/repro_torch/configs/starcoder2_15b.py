"""starcoder2-15b [dense] — GQA(kv=4), RoPE, LayerNorm+GELU+bias. [arXiv:2402.19173]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=4, head_dim=128,
        d_ff=24_576, vocab_size=49_152,
        mlp_type="gelu", norm_type="layernorm", qkv_bias=True,
        rope_theta=1e5,
    )
