"""Unified model API subset: ``build_model(cfg) -> ModelAPI``, dense and
moe families.

Ported from ``repro.models.api``: ``init`` / ``forward`` / ``prefill`` /
``decode_step`` / ``cache_shapes`` / ``paged_cache_shapes``. The train
entry (``loss``) waits for ROADMAP A18.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable                    # (gen, quant) -> params
    forward: Callable                 # (params, batch, **o) -> (logits, aux)
    prefill: Callable                 # (params, batch, **o) -> (logits, cache)
    decode_step: Callable             # (params, token, position, cache, **o)
    cache_shapes: Callable            # (batch, seq) -> shape tree

    def paged_cache_shapes(self, num_slots: int, num_physical: int,
                           block_size: int, kv_quant: str = "none"):
        """Paged-arena storage layout: ``{group: {"k": (layers,
        num_physical, block_size, Hkv, D), "v": ...}}`` (MLA: ``{"ckv":
        (layers, num_physical, block_size, kv_lora_rank), "krope": ...}``)
        — every leaf of a dense or moe model follows the sequence length,
        so every leaf is paged (``num_physical`` includes the arena's
        trailing null page).
        ``kv_quant="int8"``: each leaf becomes ``{"q": page shape (int8
        codes), "s": page shape minus the feature axis (fp16 scales)}``,
        the JAX package's ``paged_decode_specs`` layout."""
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        out = {}
        for name, shapes in self.cache_shapes(num_slots, 160).items():
            out[name] = {}
            for k, s in shapes.items():
                page = (s[0], num_physical, block_size) + s[3:]
                out[name][k] = page if kv_quant == "none" else \
                    {"q": page, "s": page[:-1]}
        return out


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            "(ssm/hybrid/encdec/vlm: ROADMAP A16)")
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(_lm_init_kw, cfg),
        forward=functools.partial(_lm_forward_kw, cfg),
        prefill=functools.partial(_lm_prefill_kw, cfg),
        decode_step=functools.partial(_lm_decode_kw, cfg),
        cache_shapes=functools.partial(lm.lm_cache_shapes, cfg),
    )


def _lm_init_kw(cfg, gen: torch.Generator, quant="none"):
    return lm.lm_init(gen, cfg, quant)


def _lm_forward_kw(cfg, params, batch, **kw):
    return lm.lm_forward(params, cfg, batch, **kw)


def _lm_prefill_kw(cfg, params, batch, **kw):
    return lm.lm_prefill(params, cfg, batch, **kw)


def _lm_decode_kw(cfg, params, token, position, cache, **kw):
    return lm.lm_decode_step(params, cfg, token, position, cache, **kw)
