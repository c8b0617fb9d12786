"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP patch STUB.
[hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072, 32 heads MHA (kv=32, head_dim 96), d_ff=8192, vocab=32064.
The vision tower is a stub, as in the reference: the caller gives (B, 576,
1024) precomputed CLIP patch embeddings, projected and prepended to the token
sequence.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072,
        num_heads=32, num_kv_heads=32, head_dim=96,
        d_ff=8192, vocab_size=32_064,
        mlp_type="swiglu", norm_type="rmsnorm",
        num_patches=576,
    )
