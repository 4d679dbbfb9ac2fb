"""jamba-v0.1-52b: [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave [arXiv:2403.19887; hf].

Layer pattern (period 8, attention at offset 4 as in the Jamba paper):
  [m, M, m, M, a, M, m, M] where lowercase=dense-FFN, uppercase=MoE-FFN
  (MoE every other layer, moe_period=2), 'a' = attention mixer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    moe=MoEConfig(
        num_experts=16,
        num_experts_per_tok=2,
        moe_d_ff=14336,
    ),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    rope_theta=10000.0,
    subquadratic=True,     # 1:7 attn:mamba — long_500k runnable
)
