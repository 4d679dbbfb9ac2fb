"""qwen3-1.7b: paper evaluation model (Section IV), not an assigned cell.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    subquadratic=False,
)
