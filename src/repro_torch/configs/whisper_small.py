"""whisper-small: [audio] 12L d_model=768 12H (kv=12, MHA) d_ff=3072
vocab=51865 — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

The conv/mel frontend is a stub per the assignment: ``input_specs()``
provides precomputed frame embeddings (batch, frames, d_model) for the
encoder. 12 encoder + 12 decoder layers; absolute/sinusoidal positions are
replaced by learned positions, attention is full (no RoPE).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_seq_len=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,         # no RoPE (learned positions)
    subquadratic=False,
)
