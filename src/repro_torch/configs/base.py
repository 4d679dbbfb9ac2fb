"""Configuration dataclasses for the repro framework.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
The config system is deliberately declarative: a config fully determines the
parameter pytree, the sharding rules, and the lowering story for every
(arch x shape x mesh) cell, so the dry-run can enumerate cells mechanically.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts configuration (routed experts + optional shared)."""

    num_experts: int
    num_experts_per_tok: int
    moe_d_ff: int                      # hidden width of each routed expert
    num_shared_experts: int = 0        # deepseek-style always-on experts
    shared_d_ff: int = 0               # hidden width of the shared expert(s)
    moe_layer_freq: int = 1            # every k-th layer is MoE (1 = all)
    first_dense_layers: int = 0        # leading dense layers (deepseek-v3: 3)
    dense_d_ff: int = 0                # d_ff for the dense (non-MoE) layers
    capacity_factor: float = 1.25      # per-expert capacity for dropped-token dispatch
    router_aux_coef: float = 0.001     # load-balance auxiliary loss coefficient


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk_size: int = 256
    conv_kernel: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture from the assigned pool.

    ``family`` selects the top-level model program:
      dense | moe        -> decoder-only LM (attention mixer)
      hybrid             -> jamba-style attn/mamba interleave (+MoE)
      ssm                -> mamba2 (attention-free)
      encdec             -> whisper-style encoder/decoder (stub frontend)
      vlm                -> decoder LM with M-RoPE + stub patch embeddings
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    mrope: bool = False               # qwen2-vl multi-section RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): one attention layer per `attn_period` layers, rest SSM.
    attn_period: int = 0
    attn_offset: int = 0              # index of the attention layer within a period
    moe_period: int = 0               # jamba: every k-th layer uses MoE FFN
    # encoder/decoder (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 1500       # default whisper frame count (stubbed frontend)
    # vlm stub frontend
    vision_tokens: int = 0            # patch embeddings prepended to the sequence
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # The paper's technique: block-quantized weights for all large linear
    # layers ("none" keeps bf16; normalization weights always stay
    # high-precision, exactly as in the paper).
    quant: str = "none"               # none | fp16 | q8_0 | q6_k | q3_k_s
    # Whether long_500k is runnable (sub-quadratic token mixing).
    subquadratic: bool = False

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def with_quant(self, quant: str) -> "ModelConfig":
        return dataclasses.replace(self, quant=quant)

    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4 if self.family != "hybrid" else 8),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_seq_len=1024,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq_len=64 if self.encoder_layers else 1500,
            vision_tokens=8 if self.vision_tokens else 0,
        )
        if self.mrope:
            # Scale M-RoPE sections to the reduced head_dim (sum == hd // 2).
            kw["mrope_sections"] = (4, 6, 6)  # sums to 16 = 32 // 2
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                num_experts_per_tok=2,
                moe_d_ff=64,
                capacity_factor=4.0,   # dropless at E=4: exact consistency
                                       # between forward and prefill/decode
                shared_d_ff=64 if self.moe.num_shared_experts else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_d_ff=128 if self.moe.dense_d_ff else 0,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=48,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.family == "hybrid":
            kw["attn_period"] = self.attn_period
            kw["moe_period"] = self.moe_period
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counting (used for roofline MODEL_FLOPS and PDP modelling)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Returns {'total': N, 'active': N_active} parameter counts."""
        d = self.d_model
        hd = self.resolved_head_dim()
        nq, nkv = self.num_heads, self.num_kv_heads
        L = self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                p = d * m.q_lora_rank + m.q_lora_rank * nq * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d
                return p
            return d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d

        def dense_ffn(dff: int) -> int:
            return 3 * d * dff  # SwiGLU: gate, up, down

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj -> [z, x, B, C, dt], conv, out_proj, A, D, dt_bias, norm
            zxbcdt = di * 2 + 2 * s.n_groups * s.d_state + nh
            return d * zxbcdt + s.conv_kernel * (di + 2 * s.n_groups * s.d_state) \
                + di * d + 3 * nh + di

        def layer_is_attn(li: int) -> bool:
            if self.family == "ssm":
                return False
            if self.family == "hybrid":
                return (li % self.attn_period) == self.attn_offset
            return True

        def layer_is_moe(li: int) -> bool:
            if self.moe is None:
                return False
            if self.family == "hybrid":
                return self.moe_period > 0 and (li % self.moe_period) == 1
            return li >= self.moe.first_dense_layers

        total = emb
        active = emb
        for li in range(L):
            mixer = attn_params() if layer_is_attn(li) else ssm_params()
            total += mixer
            active += mixer
            if self.family == "ssm":
                continue  # mamba2 has no separate FFN
            if layer_is_moe(li):
                e = self.moe
                total += e.num_experts * 3 * d * e.moe_d_ff + d * e.num_experts
                active += e.num_experts_per_tok * 3 * d * e.moe_d_ff + d * e.num_experts
                if e.num_shared_experts:
                    p = e.num_shared_experts * 3 * d * e.shared_d_ff
                    total += p
                    active += p
            else:
                dff = self.d_ff
                if self.moe is not None and self.moe.dense_d_ff:
                    dff = self.moe.dense_d_ff
                total += dense_ffn(dff)
                active += dense_ffn(dff)
        if self.encoder_layers:
            # encoder self-attn + ffn + decoder cross-attn already counted? No:
            # decoder layers counted above; add encoder stack + cross-attn.
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff))
            cross = L * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters for the end-to-end driver."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1              # gradient accumulation
    remat_policy: str = "none"         # none | full | dots_saveable
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
    # distributed-optimization knobs
    grad_compression: str = "none"     # none | int8 (quantized all-reduce)
    async_checkpoint: bool = True
