"""mamba2-2.7b [ssm] — SSD, attn-free. [arXiv:2405.21060]

64L d_model=2560, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, 1 group, conv k=4.
"""
from repro_torch.config import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560,
        num_heads=0, num_kv_heads=0, head_dim=64,
        d_ff=0, vocab_size=50_280,
        tie_embeddings=True, norm_type="rmsnorm",
        ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                   ngroups=1, chunk=256),
    )
