"""Unified model API subset: ``build_model(cfg) -> ModelAPI``, every
family of the JAX package: dense, moe, ssm, hybrid, vlm and encdec.

Ported from ``repro.models.api``: ``init`` / ``loss`` / ``forward`` /
``prefill`` / ``decode_step`` / ``cache_shapes`` /
``paged_cache_shapes``, and for the encdec family ``encode_cross`` (the
serving engine's admission-time encoder pass). ``loss`` is the train
entry (``train/trainer.py``): the families' cross entropy, with the
``remat`` policies of the JAX package; ``act_sharding`` (a training
mesh's residual placements) reaches ``lm_forward``/``lm_prefill`` and
is dropped by the encdec family, as in the JAX package.

The dry-run's abstract entry points (``launch/dryrun.py``):
``abstract_params`` (the parameter tree as meta tensors, no
allocation), ``cache_specs`` and ``input_specs`` (meta tensors of the
JAX package's ``ShapeDtypeStruct`` shapes and dtypes).

Frontend inputs (stubs, as in the JAX package): the vlm family's
``batch["vision_embeds"]`` (B, min(vision_tokens, S), d) and a decode
step's ``embeds``/``embeds_mask``; the encdec family's
``batch["frames"]`` (B, encoder_seq_len, d).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import encdec, lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable                    # (gen, quant) -> params
    loss: Callable                    # (params, batch, **o) -> scalar
    forward: Callable                 # (params, batch, **o) -> (logits, aux)
    prefill: Callable                 # (params, batch, **o) -> (logits, cache)
    decode_step: Callable             # (params, token, position, cache, **o)
    cache_shapes: Callable            # (batch, seq) -> shape tree
    encode_cross: Optional[Callable] = None   # encdec: (params, frames, **o)
    # Whether decode_step(..., rows=(fed, heads)) runs its layers on the
    # fed rows (``lm.packs_layers``; else only its head); None: it takes
    # no rows (encdec).
    packs_layers: Optional[bool] = None

    def state_leaves(self, num_slots: int):
        """The cache tree with True at each constant-size *state* leaf (SSM
        conv window and recurrent state, enc-dec cross K/V) and False at each leaf whose
        extent follows the sequence length (attention K/V, MLA latents):
        ``cache_shapes`` probed at two lengths, as the JAX package's
        arenas and ``paged_cache_shapes`` probe it."""
        return _map2(lambda a, b: a == b, self.cache_shapes(num_slots, 160),
                     self.cache_shapes(num_slots, 224))

    def paged_cache_shapes(self, num_slots: int, num_physical: int,
                           block_size: int, kv_quant: str = "none"):
        """Paged-arena storage layout: the leaves that follow the sequence
        length become pages — ``{"k": (layers, num_physical, block_size,
        Hkv, D), "v": ...}`` (MLA: ``{"ckv": (layers, num_physical,
        block_size, kv_lora_rank), "krope": ...}``; ``num_physical``
        includes the arena's trailing null page) — and the constant-size
        state leaves keep per-slot storage ``(layers, num_slots, ...)``
        (SSM ``{"conv", "ssm"}``). Detection probes ``cache_shapes`` at two
        lengths and pages exactly the leaves whose sequence axis moved, as
        the JAX package does.
        ``kv_quant="int8"``: each paged leaf becomes ``{"q": page shape
        (int8 codes), "s": page shape minus the feature axis (fp16
        scales)}``, the JAX package's ``paged_decode_specs`` layout."""
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        s_a, s_b = 160, 224      # probe lengths; avoid constant-dim collisions

        def pick(sa, sb):
            if sa == sb:
                return sa
            diff = [i for i, (x, y) in enumerate(zip(sa, sb)) if x != y]
            assert diff == [2] and sa[2] == s_a, \
                f"unsupported cache layout for paging: {sa} vs {sb}"
            page = (sa[0], num_physical, block_size) + sa[3:]
            return page if kv_quant == "none" else \
                {"q": page, "s": page[:-1]}
        return _map2(pick, self.cache_shapes(num_slots, s_a),
                     self.cache_shapes(num_slots, s_b))

    def abstract_params(self, quant: str = "none"):
        """The parameter tree as meta tensors, without allocating: the
        init run under ``FakeTensorMode``, each quantization of a weight
        replaced by planes of the shapes and dtypes it gives (one real
        quantization per distinct (shape, format) on the meta device),
        and each MoE expert bank drawn as one group."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.core.quant import pack
        from repro_torch.models import moe
        quantize, seen = pack.quantize, {}
        group = moe.EXPERT_GROUP_ELEMS

        def shaped(w, fmt):
            key = (tuple(w.shape), w.dtype, fmt)
            if key not in seen:
                seen[key] = {k: (tuple(v.shape), v.dtype) for k, v in
                             quantize(torch.empty(key[0], dtype=w.dtype,
                                                  device="meta"),
                                      fmt).items()}
            return {k: torch.empty(sh, dtype=dt)
                    for k, (sh, dt) in seen[key].items()}
        pack.quantize, moe.EXPERT_GROUP_ELEMS = shaped, 1 << 62
        try:
            with FakeTensorMode():
                gen = torch.Generator()
                gen.manual_seed(0)
                tree = self.init(gen, quant=quant)
        finally:
            pack.quantize, moe.EXPERT_GROUP_ELEMS = quantize, group
        return _map1(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), tree)

    def cache_specs(self, batch: int, seq: int,
                    dtype=torch.bfloat16) -> Dict:
        """``cache_shapes`` as meta tensors of ``dtype``."""
        return _map1(lambda sh: torch.empty(sh, dtype=dtype, device="meta"),
                     self.cache_shapes(batch, seq))

    def input_specs(self, shape: ShapeSpec, dtype=torch.bfloat16) -> Dict:
        """Meta-tensor stand-ins for the entry point of this cell: the
        train batch (tokens, labels), the prefill batch (tokens), or a
        decode step's token (B, 1), position () and cache of
        ``seq_len``; plus the family's frontend inputs."""
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32

        def meta(sh, dt):
            return torch.empty(sh, dtype=dt, device="meta")
        if shape.kind == "train":
            specs = {"tokens": meta((b, s), i32),
                     "labels": meta((b, s), i32)}
            specs.update(self._frontend_specs(b, s, dtype))
            return {"batch": specs}
        if shape.kind == "prefill":
            specs = {"tokens": meta((b, s), i32)}
            specs.update(self._frontend_specs(b, s, dtype))
            return {"batch": specs}
        return {"token": meta((b, 1), i32), "position": meta((), i32),
                "cache": self.cache_specs(b, s, dtype)}

    def _frontend_specs(self, b: int, s: int, dtype) -> Dict:
        cfg = self.cfg
        out = {}
        if cfg.family == "vlm":
            out["vision_embeds"] = torch.empty(
                (b, min(cfg.vision_tokens, s), cfg.d_model), dtype=dtype,
                device="meta")
        if cfg.family == "encdec":
            out["frames"] = torch.empty(
                (b, cfg.encoder_seq_len, cfg.d_model), dtype=dtype,
                device="meta")
        return out


def _map1(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists (a shape tuple
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map1(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map1(fn, v) for v in tree]
    return fn(tree)


def _map2(fn, ta, tb):
    """``fn`` over the paired leaves (shape tuples) of two nested dicts."""
    if isinstance(ta, dict):
        return {k: _map2(fn, ta[k], tb[k]) for k in ta}
    return fn(ta, tb)


# Families of the JAX package not ported yet -> the ROADMAP item: none
# since the vlm (A16b) and encdec (A16c) families were ported.
PENDING_FAMILIES: Dict[str, str] = {}


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in PENDING_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: "
            f"{PENDING_FAMILIES[cfg.family]}")
    if cfg.family == "encdec":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, quant="none": encdec.encdec_init(gen, cfg,
                                                              quant),
            loss=functools.partial(_encdec_loss_kw, cfg),
            forward=lambda params, batch, **kw: encdec.encdec_forward(
                params, cfg, batch, **_strip(kw)),
            prefill=lambda params, batch, **kw: encdec.encdec_prefill(
                params, cfg, batch, **_strip(kw)),
            decode_step=lambda params, token, position, cache, **kw:
                encdec.encdec_decode_step(params, cfg, token, position,
                                          cache, **kw),
            cache_shapes=functools.partial(encdec.encdec_cache_shapes, cfg),
            encode_cross=lambda params, frames, **kw:
                encdec.encdec_encode_cross(params, cfg, frames, **kw),
        )
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(_lm_init_kw, cfg),
        loss=functools.partial(_lm_loss_kw, cfg),
        forward=functools.partial(_lm_forward_kw, cfg),
        prefill=functools.partial(_lm_prefill_kw, cfg),
        decode_step=functools.partial(_lm_decode_kw, cfg),
        cache_shapes=functools.partial(lm.lm_cache_shapes, cfg),
        packs_layers=lm.packs_layers(cfg),
    )


def _strip(kw: Dict) -> Dict:
    """``kw`` without act_sharding (the encdec functions take none)."""
    return {k: v for k, v in kw.items() if k != "act_sharding"}


def _lm_init_kw(cfg, gen: torch.Generator, quant="none"):
    return lm.lm_init(gen, cfg, quant)


def _lm_loss_kw(cfg, params, batch, **kw):
    return lm.lm_loss(params, cfg, batch, **kw)


def _encdec_loss_kw(cfg, params, batch, act_sharding=None, **kw):
    # The encdec functions take no act_sharding: dropped, as the JAX
    # package drops it (whisper is small).
    return encdec.encdec_loss(params, cfg, batch, **kw)


def _lm_forward_kw(cfg, params, batch, **kw):
    return lm.lm_forward(params, cfg, batch, **kw)


def _lm_prefill_kw(cfg, params, batch, **kw):
    return lm.lm_prefill(params, cfg, batch, **kw)


def _lm_decode_kw(cfg, params, token, position, cache, **kw):
    return lm.lm_decode_step(params, cfg, token, position, cache, **kw)
