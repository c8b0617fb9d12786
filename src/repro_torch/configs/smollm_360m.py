"""smollm-360m [dense] — llama-arch small, GQA(kv=5). [hf:HuggingFaceTB/SmolLM]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960,
        num_heads=15, num_kv_heads=5, head_dim=64,
        d_ff=2560, vocab_size=49_152,
        mlp_type="swiglu", norm_type="rmsnorm",
        tie_embeddings=True,
    )
