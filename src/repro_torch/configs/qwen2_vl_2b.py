"""qwen2-vl-2b: [vlm] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE, dynamic resolution [arXiv:2409.12191; hf].  The vision frontend is a
STUB per the assignment: ``input_specs()`` provides precomputed patch
embeddings of shape (batch, vision_tokens, d_model) which the backbone
consumes directly (merged ahead of the text tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    rope_theta=1000000.0,
    vision_tokens=256,     # stub: one image worth of merged patch embeddings
    subquadratic=False,
)
