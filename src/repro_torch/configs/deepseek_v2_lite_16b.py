"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + MoE. [arXiv:2405.04434]

27 layers, d_model 2048, 16 heads; MLA: kv_lora_rank 512, qk_nope 128,
qk_rope 64, v 128.  MoE: 64 routed experts top-6 + 2 shared, expert d_ff
1408; the first layer is dense, its FFN the real model's 10944."""
from repro_torch.config import ArchConfig, MLACfg, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=10_944, vocab_size=102_400,
        mlp_type="swiglu", norm_type="rmsnorm",
        mla=MLACfg(kv_lora_rank=512, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128),
        moe=MoECfg(num_experts=64, top_k=6, d_ff=1408, num_shared=2,
                   period=1, offset=0, first_k_dense=1),
    )
