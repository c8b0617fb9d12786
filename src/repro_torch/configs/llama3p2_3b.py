"""llama3.2-3b [dense] — small llama3. [hf:meta-llama/Llama-3.2-*]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072,
        num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=128_256,
        mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=True, rope_theta=500_000.0,
    )
