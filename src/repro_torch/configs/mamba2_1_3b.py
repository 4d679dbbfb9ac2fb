"""mamba2-1.3b: [ssm] 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads, n_groups=1.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  chunk_size=256, conv_kernel=4),
    tie_embeddings=True,
    subquadratic=True,      # attention-free — long_500k runnable
)
