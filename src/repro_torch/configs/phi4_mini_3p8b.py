"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA(kv=8). [arXiv:2412.08905]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense",
        num_layers=32, d_model=3072,
        num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=200_064,
        mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=True,   # phi-4-mini shares input/output embeddings
    )
