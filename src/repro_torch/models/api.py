"""Unified model API subset: ``build_model(cfg) -> ModelAPI``, dense family.

Ported from ``repro.models.api``: ``init`` / ``decode_step`` /
``cache_shapes`` / ``paged_cache_shapes``. The train, forward and
prefill entries wait for ROADMAP A18 and A10.
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
    decode_step: Callable             # (params, token, position, cache, **o)
    cache_shapes: Callable            # (batch, seq) -> shape tree

    def paged_cache_shapes(self, num_slots: int, num_physical: int,
                           block_size: int):
        """Paged-arena storage layout: ``{group: {"k": (layers,
        num_physical, block_size, Hkv, D), "v": ...}}`` — every leaf of a
        dense model follows the sequence length, so every leaf is paged
        (``num_physical`` includes the arena's trailing null page)."""
        out = {}
        for name, shapes in self.cache_shapes(num_slots, 160).items():
            out[name] = {k: (s[0], num_physical, block_size) + s[3:]
                         for k, s in shapes.items()}
        return out


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            "(moe: ROADMAP A15; ssm/hybrid/encdec/vlm: A16)")
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(_lm_init_kw, cfg),
        decode_step=functools.partial(_lm_decode_kw, cfg),
        cache_shapes=functools.partial(lm.lm_cache_shapes, cfg),
    )


def _lm_init_kw(cfg, gen: torch.Generator, quant="none"):
    return lm.lm_init(gen, cfg, quant)


def _lm_decode_kw(cfg, params, token, position, cache, **kw):
    return lm.lm_decode_step(params, cfg, token, position, cache, **kw)
