"""Architecture registry for the port: ``--arch <id>`` resolution.

Every architecture of ``repro`` is ported: the dense qwen3 family (the
paper's own evaluation models) and the other dense configs, llama3.2-3b
(tied embeddings), qwen2-72b (qkv bias) and llama3-405b (128 heads over
8 kv-heads); the two MoE models, deepseek-v3 (MLA + MoE) and
granite-moe (GQA + MoE); the recurrent families, mamba2 (SSD,
attention-free) and jamba (Mamba + attention + MoE); and the
conditioned ones, whisper (encoder-decoder) and qwen2-vl (M-RoPE,
vision-embed merge).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_0_6b
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3_1_7b
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.whisper_small import CONFIG as _whisper

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [_qwen3_0_6b, _qwen3_1_7b, _qwen3_8b, _llama3_2_3b,
                        _qwen2_72b, _llama3_405b, _deepseek_v3,
                        _granite_moe, _mamba2, _jamba, _whisper, _qwen2_vl]
}

# The 10 assigned architectures (40 dry-run cells), in the JAX package's
# order.
ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c for c in [_llama3_2_3b, _qwen2_72b, _llama3_405b,
                        _qwen3_0_6b, _qwen2_vl, _jamba, _deepseek_v3,
                        _granite_moe, _whisper, _mamba2]
}

# Architectures of the JAX package not ported yet -> the ROADMAP item
# that ports them: none since the last dense configs (A20).
PENDING: Dict[str, str] = {}


def family_of(name: str) -> str:
    """The model family of architecture ``name``."""
    if name in ARCHS:
        return ARCHS[name].family
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    """The ported config called ``name``; raises for any other name."""
    if name in ARCHS:
        return ARCHS[name]
    if name in PENDING:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: "
            f"{PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
