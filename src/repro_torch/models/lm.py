"""Decoder-only LM assembly, dense and moe families, ported from
``repro.models.lm``.

Parameters are plain dicts of tensors. The JAX package stacks each layer
group along a leading axis and scans over it (``jax.lax.scan``); here a
group is a Python list of per-layer dicts and every pass is a Python
loop over the layer index. The KV caches keep the stacked layout
``{group: {"k": (layers, ...), "v": ...}}`` (MLA: ``{"ckv", "krope"}``)
— paged (layers, NP, bs, ...), with ``{"q", "s"}`` dicts on an int8
arena, or contiguous (layers, B, S, ...) — and layer ``i`` writes in
place through the view ``cache[group]["k"][i]``. ``lm_prefill`` returns
its caches in the same stacked layout.

Embeddings come from plain tokens only: M-RoPE, vision and encoder
inputs wait for ROADMAP A16.

Ported layer kinds: the GQA and MLA mixers, the dense SwiGLU and the MoE
FFN (the dense and moe families: qwen3, granite-moe, deepseek-v3, whose
first ``first_dense_layers`` FFNs are dense at ``dense_d_ff``). SSM,
hybrid, enc-dec and vlm wait for ROADMAP A16.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models.layers import Params


def _mixer_kind(cfg: ModelConfig, li: int) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "gqa" if (li % cfg.attn_period) == cfg.attn_offset else "ssm"
    if cfg.mla is not None:
        return "mla"
    return "gqa"


def _ffn_kind(cfg: ModelConfig, li: int) -> str:
    if cfg.family == "ssm":
        return "none"
    if cfg.family == "hybrid":
        return "moe" if (cfg.moe_period and li % cfg.moe_period == 1) \
            else "dense"
    if cfg.moe is not None:
        return "moe" if li >= cfg.moe.first_dense_layers else "dense"
    return "dense"


def layer_groups(cfg: ModelConfig):
    """Returns list of (group_name, count, [(mixer, ffn), ...per sub-layer])
    — the same groups (and names) as the JAX package."""
    if cfg.family == "hybrid":
        period = cfg.attn_period
        assert cfg.num_layers % period == 0
        subs = [(_mixer_kind(cfg, i), _ffn_kind(cfg, i))
                for i in range(period)]
        return [("blocks", cfg.num_layers // period, subs)]
    sigs = [(_mixer_kind(cfg, i), _ffn_kind(cfg, i))
            for i in range(cfg.num_layers)]
    groups = []
    start = 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or sigs[i] != sigs[start]:
            groups.append((f"layers{len(groups)}", i - start, [sigs[start]]))
            start = i
    return groups


def _check_ported(cfg: ModelConfig) -> None:
    for _, _, subs in layer_groups(cfg):
        for mixer, ffn in subs:
            if mixer not in ("gqa", "mla") or ffn not in ("dense", "moe"):
                raise NotImplementedError(
                    f"{cfg.name}: the ({mixer}, {ffn}) layer is not ported "
                    "(ssm/hybrid/encdec/vlm are ROADMAP A16)")


def layer_init(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str,
               fmt: str) -> Params:
    p: Params = {"mixer_norm": layers.rmsnorm_init(cfg.d_model, gen.device)}
    p["attn"] = (attn.mla_init if mixer == "mla" else attn.gqa_init)(
        gen, cfg, fmt)
    p["ffn_norm"] = layers.rmsnorm_init(cfg.d_model, gen.device)
    if ffn == "moe":
        p["ffn"] = moe.moe_init(gen, cfg, fmt)
    else:
        dff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            dff = cfg.moe.dense_d_ff
        p["ffn"] = layers.swiglu_init(gen, cfg.d_model, dff, fmt)
    return p


def lm_init(gen: torch.Generator, cfg: ModelConfig,
            quant: str = "none") -> Params:
    """Random parameters on ``gen.device`` from the generator's stream."""
    _check_ported(cfg)
    recipe = layers.recipe_for(quant)
    fmt_lin, fmt_emb = recipe["linear"], recipe["embed"]
    params: Params = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       fmt_emb),
        "final_norm": layers.rmsnorm_init(cfg.d_model, gen.device),
    }
    for name, count, subs in layer_groups(cfg):
        (mixer, ffn), = subs
        params[name] = [layer_init(gen, cfg, mixer, ffn, fmt_lin)
                        for _ in range(count)]
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(
            gen, cfg.d_model, cfg.vocab_size, fmt_emb)
    return params


def _ffn(p: Params, cfg: ModelConfig, h: torch.Tensor, ffn: str, fmt: str):
    """Pre-norm FFN residual: (h + FFN(norm(h)), the MoE aux loss or None
    for a dense FFN)."""
    hn = layers.rmsnorm_apply(p["ffn_norm"], h, cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe.moe_apply(p["ffn"], cfg, hn, fmt=fmt)
        return h + y, aux
    return h + layers.swiglu_apply(p["ffn"], hn, fmt), None


def layer_apply(p: Params, cfg: ModelConfig, h: torch.Tensor, rope, *,
                mixer: str, ffn: str, fmt: str):
    """Full-sequence layer (forward). ``rope``: the pass's shared
    ``attention.rope_tables``. Returns (h, aux loss or None)."""
    h, _, aux = layer_prefill(p, cfg, h, rope, mixer=mixer, ffn=ffn, fmt=fmt)
    return h, aux


def layer_prefill(p: Params, cfg: ModelConfig, h: torch.Tensor, rope, *,
                  mixer: str, ffn: str, fmt: str):
    """Full-sequence layer that also returns its cache ({"k", "v"}, or
    MLA's {"ckv", "krope"}). Returns (h, cache, aux loss or None)."""
    hn = layers.rmsnorm_apply(p["mixer_norm"], h, cfg.norm_eps)
    prefill = attn.mla_prefill if mixer == "mla" else attn.gqa_prefill
    mix, cache = prefill(p["attn"], cfg, hn, rope, fmt=fmt)
    h, aux = _ffn(p, cfg, h + mix, ffn, fmt)
    return h, cache, aux


def layer_decode(p: Params, cfg: ModelConfig, h: torch.Tensor,
                 position: torch.Tensor, cache: Dict, *, mixer: str,
                 ffn: str, fmt: str, block_tables: torch.Tensor,
                 lengths=None, paged_impl: str = "fused",
                 step: Optional[attn.PagedStep] = None) -> torch.Tensor:
    """Decode layer step over a chunk of C tokens; writes this layer's
    pages in ``cache`` in place. Returns h."""
    hn = layers.rmsnorm_apply(p["mixer_norm"], h, cfg.norm_eps)
    decode = attn.mla_decode if mixer == "mla" else attn.gqa_decode
    mix, _ = decode(p["attn"], cfg, hn, position, cache, fmt=fmt,
                    block_tables=block_tables, lengths=lengths,
                    paged_impl=paged_impl, step=step)
    return _ffn(p, cfg, h + mix, ffn, fmt)[0]


def _lm_head(params, cfg: ModelConfig, h, quant: str):
    recipe = layers.recipe_for(quant)
    if cfg.tie_embeddings:
        return layers.embedding_logits(params["embed"], h, recipe["embed"])
    return layers.linear_apply(params["lm_head"], h, recipe["embed"])


def _embed_tokens(params, cfg: ModelConfig, batch: Dict, quant: str):
    """(h, rope): the batch's token embeddings in bf16 and the RoPE
    tables of its (B, S) positions. Only ``batch["tokens"]`` is read; vision and
    encoder inputs are ROADMAP A16."""
    extra = set(batch) - {"tokens", "labels"}
    if extra or cfg.mrope:
        raise NotImplementedError(
            f"inputs {sorted(extra)} / M-RoPE are ROADMAP A16; the port "
            "embeds plain tokens only")
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = layers.embedding_lookup(params["embed"], tokens,
                                layers.recipe_for(quant)["embed"],
                                torch.bfloat16, width=cfg.d_model)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return h, attn.rope_tables(cfg, positions)


def lm_forward(params, cfg: ModelConfig, batch: Dict, *, quant="none"):
    """Full-sequence forward over ``batch["tokens"]`` (B, S). Returns
    (logits (B, S, V), aux_loss): the MoE layers' load-balance losses
    summed (0 for the dense family)."""
    fmt = layers.recipe_for(quant)["linear"]
    h, rope = _embed_tokens(params, cfg, batch, quant)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for name, _, subs in layer_groups(cfg):
        (mixer, ffn), = subs
        for lp in params[name]:
            h, aux = layer_apply(lp, cfg, h, rope, mixer=mixer, ffn=ffn,
                                 fmt=fmt)
            if aux is not None:
                aux_total = aux_total + aux
    h = layers.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return _lm_head(params, cfg, h, quant), aux_total


def lm_prefill(params, cfg: ModelConfig, batch: Dict, *, quant="none"):
    """Prefill: returns (last-token logits (B, 1, V), caches) with caches
    ``{group: {"k": (layers, B, S, Hkv, D), "v": ...}}`` (MLA:
    ``{"ckv": (layers, B, S, rank), "krope": ...}``), the JAX package's
    stacked layout."""
    fmt = layers.recipe_for(quant)["linear"]
    h, rope = _embed_tokens(params, cfg, batch, quant)
    caches = {}
    for name, _, subs in layer_groups(cfg):
        (mixer, ffn), = subs
        per_layer = []
        for lp in params[name]:
            h, c, _ = layer_prefill(lp, cfg, h, rope, mixer=mixer, ffn=ffn,
                                    fmt=fmt)
            per_layer.append(c)
        caches[name] = {k: torch.stack([c[k] for c in per_layer])
                        for k in per_layer[0]}
    h = layers.rmsnorm_apply(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return _lm_head(params, cfg, h, quant), caches


def _layer_leaf(leaf, i: int):
    """Layer ``i``'s view of a stacked cache leaf (or {"q", "s"} dict)."""
    if isinstance(leaf, dict):
        return {k: v[i] for k, v in leaf.items()}
    return leaf[i]


def lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                   position: torch.Tensor, cache: Dict, *, quant="none",
                   block_tables: Optional[torch.Tensor] = None, lengths=None,
                   paged_impl="fused"):
    """token: (B, C) int — a chunk of consecutive tokens per slot;
    position: (B,) int base positions (chunk entry i sits at base + i);
    cache: the arena's buffers (written in place) — pages read through
    ``block_tables``, or the contiguous slot arena when that is None.
    Returns (logits (B, C, V) in the activation dtype bf16, cache).

    ``lengths``: (B,) valid chunk entries per row — cache writes past a
    row's length are dropped, and its tail logits are garbage by contract
    (the engine samples at index ``lengths - 1``)."""
    recipe = layers.recipe_for(quant)
    fmt = recipe["linear"]
    h = layers.embedding_lookup(params["embed"], token, recipe["embed"],
                                torch.bfloat16, width=cfg.d_model)
    step = None
    for name, count, subs in layer_groups(cfg):
        (mixer, ffn), = subs
        group = cache[name]
        for i, lp in enumerate(params[name]):
            layer_cache = {k: _layer_leaf(v, i) for k, v in group.items()}
            if step is None:        # one routing/RoPE plan for all layers
                step = attn.paged_step(cfg, position, block_tables, lengths,
                                       next(iter(layer_cache.values())),
                                       token.shape[1])
            h = layer_decode(lp, cfg, h, position, layer_cache, mixer=mixer,
                             ffn=ffn, fmt=fmt, block_tables=block_tables,
                             lengths=lengths, paged_impl=paged_impl,
                             step=step)
    h = layers.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return _lm_head(params, cfg, h, quant), cache


def lm_cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Cache shapes per layer group (leading layer axis)."""
    out = {}
    for name, count, subs in layer_groups(cfg):
        (mixer, _), = subs
        shape = (attn.mla_cache_shape if mixer == "mla"
                 else attn.gqa_cache_shape)(cfg, batch, seq)
        out[name] = {k: (count,) + v for k, v in shape.items()}
    return out
