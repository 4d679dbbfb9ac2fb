"""qwen3-0.6b: [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].  Also one of the paper's own
evaluation models (Qwen3-0.6B in Section IV).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,          # Qwen3 uses explicit head_dim=128 (16*128 != d_model)
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    subquadratic=False,
)
