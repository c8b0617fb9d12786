"""whisper-tiny [audio] — encoder-decoder; the conv frontend is a stub
(precomputed frame embeddings), as in the reference. [arXiv:2212.04356]

4 encoder + 4 decoder layers, d_model=384, 6 heads (MHA), d_ff=1536,
vocab=51865, LayerNorm+GELU+bias, cross-attention decoder.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        num_layers=4, d_model=384,
        num_heads=6, num_kv_heads=6, head_dim=64,
        d_ff=1536, vocab_size=51_865,
        mlp_type="gelu", norm_type="layernorm", qkv_bias=True,
        tie_embeddings=True,
        encoder_layers=4, cross_attention=True,
    )
