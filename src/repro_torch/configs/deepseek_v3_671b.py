"""deepseek-v3-671b: [moe] 61L d_model=7168 128H d_ff=2048(moe) vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437; hf].

First 3 layers are dense FFN (d_ff 18432) per the DeepSeek-V3 report; MLA
with kv_lora_rank 512 / q_lora_rank 1536 / rope head dim 64.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,       # MLA: effectively MHA over latent KV
    d_ff=18432,             # dense layers' FFN width
    vocab_size=129280,
    head_dim=128,
    moe=MoEConfig(
        num_experts=256,
        num_experts_per_tok=8,
        moe_d_ff=2048,
        num_shared_experts=1,
        shared_d_ff=2048,
        first_dense_layers=3,
        dense_d_ff=18432,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    rope_theta=10000.0,
    subquadratic=False,
)
