"""qwen3-8b: paper evaluation model (Section IV), not an assigned cell.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    subquadratic=False,
)
