"""granite-moe-3b-a800m: [moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512,
MoE 40e top-8 vocab=49155 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(
        num_experts=40,
        num_experts_per_tok=8,
        moe_d_ff=512,
    ),
    tie_embeddings=True,
    rope_theta=10000.0,
    subquadratic=False,
)
