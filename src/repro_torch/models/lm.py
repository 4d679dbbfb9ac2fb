"""Decoder-only LM assembly, ported from ``repro.models.lm``: the dense,
moe and vlm (qwen2-vl) families and the recurrent ones, ssm (mamba2) and
hybrid (jamba).

Parameters are plain dicts of tensors. The JAX package stacks each layer
group along a leading axis and scans over it (``jax.lax.scan``); here a
group is a Python list of per-layer dicts and every pass is a Python
loop over the layer index. jamba's period-8 pattern is one group,
``"blocks"``, whose entries are dicts of 8 distinct sub-layers
``sub0..sub7`` (the JAX package's layout). The caches keep the stacked
layout ``{group: {"k": (layers, ...), "v": ...}}`` (MLA: ``{"ckv",
"krope"}``; an SSM layer: ``{"conv", "ssm"}``; jamba: ``{"blocks":
{"sub{i}": ...}}``) — attention leaves paged (layers, NP, bs, ...), with
``{"q", "s"}`` dicts on an int8 arena, or contiguous (layers, B, S,
...); SSM state leaves per slot (layers, B, ...) on either arena — and
layer ``i`` writes in place through the view ``cache[group][leaf][i]``.
``lm_prefill`` returns its caches in the same stacked layout.

The vlm family (qwen2-vl) merges its stub vision embeddings ahead of
the text tokens (``_embed_inputs``; a decode chunk takes them through
``embeds``/``embeds_mask``) and rotates by M-RoPE position streams
(``_mrope_positions`` at prefill, ``_mrope_decode_positions`` per
decode chunk). The encoder-decoder family is ``models/encdec.py``.

Ported layer kinds: the GQA, MLA and SSM (mamba2) mixers; the dense
SwiGLU, the MoE FFN and no FFN (mamba2). deepseek-v3's first
``first_dense_layers`` FFNs are dense at ``dense_d_ff``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.models.layers import Params
from repro_torch.parallel import sharding


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


def _has_attention(cfg: ModelConfig) -> bool:
    return any(mixer != "ssm" for _, _, subs in layer_groups(cfg)
               for mixer, _ in subs)


def _group_layers(group_params, subs, group_cache=None):
    """The layers of one group in order: (params, mixer, ffn, cache view
    or None) — a plain group's entries, or each block's sub-layers
    ``sub0..`` for jamba's hybrid group. The cache view is layer ``i``'s
    slice of the group's stacked leaves."""
    for i, lp in enumerate(group_params):
        for j, (mixer, ffn) in enumerate(subs):
            sub = lp if len(subs) == 1 else lp[f"sub{j}"]
            view = None
            if group_cache is not None:
                leaves = group_cache if len(subs) == 1 \
                    else group_cache[f"sub{j}"]
                view = {k: _layer_leaf(v, i) for k, v in leaves.items()}
            yield sub, mixer, ffn, view


def layer_init(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str,
               fmt: str) -> Params:
    p: Params = {"mixer_norm": layers.rmsnorm_init(cfg.d_model, gen.device)}
    if mixer == "ssm":
        p["ssm"] = ssm.ssm_init(gen, cfg, fmt)
    else:
        p["attn"] = (attn.mla_init if mixer == "mla" else attn.gqa_init)(
            gen, cfg, fmt)
    if ffn == "none":
        return p
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
    recipe = layers.recipe_for(quant)
    fmt_lin, fmt_emb = recipe["linear"], recipe["embed"]
    params: Params = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       fmt_emb),
        "final_norm": layers.rmsnorm_init(cfg.d_model, gen.device),
    }
    for name, count, subs in layer_groups(cfg):
        if len(subs) == 1:
            (mixer, ffn), = subs
            params[name] = [layer_init(gen, cfg, mixer, ffn, fmt_lin)
                            for _ in range(count)]
        else:
            params[name] = [{f"sub{j}": layer_init(gen, cfg, mixer, ffn,
                                                   fmt_lin)
                             for j, (mixer, ffn) in enumerate(subs)}
                            for _ in range(count)]
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(
            gen, cfg.d_model, cfg.vocab_size, fmt_emb)
    return params


def _ffn(p: Params, cfg: ModelConfig, h: torch.Tensor, ffn: str, fmt: str):
    """Pre-norm FFN residual: (h + FFN(norm(h)), the MoE aux loss or None
    for a dense FFN); h itself for a layer without FFN (mamba2)."""
    if ffn == "none":
        return h, None
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
    """Full-sequence layer that also returns its cache ({"k", "v"}, MLA's
    {"ckv", "krope"}, or the SSM's final {"conv", "ssm"} state). Returns
    (h, cache, aux loss or None)."""
    hn = layers.rmsnorm_apply(p["mixer_norm"], h, cfg.norm_eps)
    if mixer == "ssm":
        mix, cache = ssm.ssm_apply(p["ssm"], cfg, hn, fmt=fmt,
                                   return_state=True)
    else:
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
    pages (or, for an SSM layer, its slots' state) in ``cache`` in place.
    Returns h."""
    hn = layers.rmsnorm_apply(p["mixer_norm"], h, cfg.norm_eps)
    if mixer == "ssm":
        mix, _ = ssm.ssm_decode(p["ssm"], cfg, hn, cache, fmt=fmt,
                                lengths=lengths)
    else:
        decode = attn.mla_decode if mixer == "mla" else attn.gqa_decode
        mix, _ = decode(p["attn"], cfg, hn, position, cache, fmt=fmt,
                        block_tables=block_tables, lengths=lengths,
                        paged_impl=paged_impl, step=step)
    return _ffn(p, cfg, h + mix, ffn, fmt)[0]


def packs_layers(cfg: ModelConfig) -> bool:
    """Whether a packed decode step runs its layers on the fed rows: no
    layer reads across rows. An SSM mixer walks its slot's chunk; an MoE
    FFN routes every row of the step into expert capacity they share,
    the rows no slot feeds included, so each of those must hold what the
    padded step gives it in every layer before. MLA (``mla_decode``)
    takes the padded layout alone; its one model is MoE. Where such a
    layer exists, the layers run padded and only the final norm and the
    head on the fed rows."""
    return cfg.mla is None and not any(
        mixer == "ssm" or ffn == "moe"
        for _, _, subs in layer_groups(cfg) for mixer, ffn in subs)


def _lm_head(params, cfg: ModelConfig, h, quant: str):
    recipe = layers.recipe_for(quant)
    if cfg.tie_embeddings:
        return layers.embedding_logits(params["embed"], h, recipe["embed"])
    return layers.linear_apply(params["lm_head"], h, recipe["embed"])


def _mrope_positions(cfg: ModelConfig, batch: int, seq: int, device):
    """Deterministic stub M-RoPE position grid (B, S, 3): vision tokens
    get a (t=0, h, w) raster; text tokens advance temporally after the
    image."""
    v = min(cfg.vision_tokens, seq)
    side = max(int(v ** 0.5), 1)
    idx = torch.arange(seq, device=device)
    is_vis = idx < v
    txt = idx - v + side
    t_pos = torch.where(is_vis, torch.zeros_like(idx), txt)
    h_pos = torch.where(is_vis, idx // side, txt)
    w_pos = torch.where(is_vis, idx % side, txt)
    pos3 = torch.stack([t_pos, h_pos, w_pos], dim=-1)      # (S, 3)
    return pos3[None].expand(batch, seq, 3)


def _mrope_decode_positions(cfg: ModelConfig, pos_mat: torch.Tensor):
    """(B, C, 3) M-RoPE positions for absolute positions ``pos_mat``
    (B, C): vision positions (< vision_tokens) get the (t=0, h, w) raster,
    text positions advance all three streams together — the mapping
    ``_mrope_positions`` applies at prefill, evaluated pointwise so a
    decode chunk can span the vision/text boundary."""
    v = cfg.vision_tokens
    side = max(int(v ** 0.5), 1)
    is_vis = pos_mat < v
    txt = pos_mat - v + side
    t_pos = torch.where(is_vis, torch.zeros_like(pos_mat), txt)
    h_pos = torch.where(is_vis, pos_mat // side, txt)
    w_pos = torch.where(is_vis, pos_mat % side, txt)
    return torch.stack([t_pos, h_pos, w_pos], dim=-1)


def _embed_inputs(params, cfg: ModelConfig, batch: Dict, quant: str):
    """(h, rope): the batch's embeddings in bf16 — for the vlm family the
    stub vision prefix ``batch["vision_embeds"]`` in place of the first
    tokens' — and the RoPE tables of its positions (M-RoPE streams for
    qwen2-vl; None without attention). An input the family does not
    take is refused, not ignored."""
    extra = set(batch) - {"tokens", "labels"} - (
        {"vision_embeds"} if cfg.family == "vlm" else set())
    if extra:
        raise ValueError(f"{cfg.name} ({cfg.family} family) takes no "
                         f"inputs {sorted(extra)}: only the vlm family "
                         "merges vision_embeds")
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = layers.embedding_lookup(params["embed"], tokens,
                                layers.recipe_for(quant)["embed"],
                                torch.bfloat16, width=cfg.d_model)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        # Clip the vision prefix to the sequence being embedded: a
        # sequence shorter than the vision grid must not widen past its
        # position vectors.
        v = min(batch["vision_embeds"].shape[1], s)
        h = torch.cat([batch["vision_embeds"][:, :v].to(h.dtype),
                       h[:, v:]], dim=1)
    if not _has_attention(cfg):
        return h, None
    if cfg.mrope:
        positions = _mrope_positions(cfg, b, s, tokens.device)
    else:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return h, attn.rope_tables(cfg, positions)


def lm_forward(params, cfg: ModelConfig, batch: Dict, *, quant="none",
               remat: str = "none", act_sharding=None):
    """Full-sequence forward over ``batch["tokens"]`` (B, S). Returns
    (logits (B, S, V), aux_loss): the MoE layers' load-balance losses
    summed (0 for the dense family).

    ``remat`` (training): each entry of a layer group — one layer, or
    one jamba block of 8 sub-layers, the JAX package's scanned body —
    runs under ``layers.remat``. ``act_sharding``: the residual's DTensor
    placements on a training mesh (``sharding.activation_sharding``);
    the residual is redistributed to them after the embedding and after
    each group entry, where the JAX package constrains it, and each
    entry takes it with the sequence whole (``sharding.sequence_whole``:
    an eager step has no partitioner to pick the layout inside a layer).
    Off a mesh (plain tensors) it changes nothing, as
    ``with_sharding_constraint`` changes no value."""
    fmt = layers.recipe_for(quant)["linear"]
    h, rope = _embed_inputs(params, cfg, batch, quant)
    h = sharding.constrain(h, act_sharding)
    whole = sharding.sequence_whole(act_sharding)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for name, _, subs in layer_groups(cfg):
        def body(h, lp, subs=subs):
            h = sharding.constrain(h, whole)
            aux_g = torch.zeros((), dtype=torch.float32, device=h.device)
            for j, (mixer, ffn) in enumerate(subs):
                sub = lp if len(subs) == 1 else lp[f"sub{j}"]
                h, aux = layer_apply(sub, cfg, h, rope, mixer=mixer, ffn=ffn,
                                     fmt=fmt)
                if aux is not None:
                    aux_g = aux_g + aux
            return sharding.constrain(h, act_sharding), aux_g
        body = layers.remat(body, remat)
        for lp in params[name]:
            h, aux = body(h, lp)
            aux_total = aux_total + aux
    h = sharding.constrain(h, whole)
    h = layers.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
    return _lm_head(params, cfg, h, quant), aux_total


def lm_loss(params, cfg: ModelConfig, batch: Dict, *, quant="none",
            remat: str = "none", act_sharding=None) -> torch.Tensor:
    """Next-token cross entropy over ``labels >= 0`` plus, for the MoE
    families, ``router_aux_coef`` x the load-balance loss."""
    logits, aux = lm_forward(params, cfg, batch, quant=quant, remat=remat,
                             act_sharding=act_sharding)
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    return layers.cross_entropy(logits, batch["labels"]) + coef * aux


def lm_prefill(params, cfg: ModelConfig, batch: Dict, *, quant="none",
               act_sharding=None):
    """Prefill: returns (last-token logits (B, 1, V), caches) with caches
    ``{group: {"k": (layers, B, S, Hkv, D), "v": ...}}`` (MLA:
    ``{"ckv": (layers, B, S, rank), "krope": ...}``; SSM: ``{"conv":
    (layers, B, K-1, conv_dim), "ssm": (layers, B, H, N, P)}``; jamba:
    ``{"blocks": {"sub{i}": ...}}``), the JAX package's stacked layout.
    ``act_sharding`` as ``lm_forward``'s: the embedded residual is
    redistributed to it on a training mesh."""
    fmt = layers.recipe_for(quant)["linear"]
    h, rope = _embed_inputs(params, cfg, batch, quant)
    h = sharding.constrain(h, act_sharding)
    h = sharding.constrain(h, sharding.sequence_whole(act_sharding))
    caches = {}
    for name, _, subs in layer_groups(cfg):
        per_sub = [[] for _ in subs]
        for n, (lp, mixer, ffn, _) in enumerate(_group_layers(params[name],
                                                              subs)):
            h, c, _ = layer_prefill(lp, cfg, h, rope, mixer=mixer, ffn=ffn,
                                    fmt=fmt)
            per_sub[n % len(subs)].append(c)
        stacked = [{k: torch.stack([c[k] for c in per_layer])
                    for k in per_layer[0]} for per_layer in per_sub]
        caches[name] = stacked[0] if len(subs) == 1 else \
            {f"sub{j}": c for j, c in enumerate(stacked)}
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
                   paged_impl="fused", embeds=None, embeds_mask=None,
                   rows=None):
    """token: (B, C) int — a chunk of consecutive tokens per slot;
    position: (B,) int base positions (chunk entry i sits at base + i);
    cache: the arena's buffers (written in place) — pages read through
    ``block_tables``, or the contiguous slot arena when that is None.
    Returns (logits (B, C, V) in the activation dtype bf16, cache).

    ``lengths``: (B,) valid chunk entries per row — cache writes past a
    row's length are dropped, and its tail logits are garbage by contract
    (the engine samples at index ``lengths - 1``).

    ``embeds``/``embeds_mask``: (B, C, d) / (B, C) — vlm chunked prefill:
    positions flagged in the mask take the provided embedding (the stub
    vision patches) instead of the token embedding.

    ``rows``: (fed, heads) to run the step packed. ``fed`` (R,) int64:
    the flat indices ``slot * C + i`` (``i < lengths[slot]``) of the
    rows the step feeds, in slot order; ``heads`` (L,) int64: positions
    in ``fed`` of the rows whose logits to return. Where
    ``packs_layers``, the embedding and the token-wise layers then run
    on the R fed rows and only the attention core sees the (B, C)
    layout; the final norm and the head run on the L rows. Every
    hand-written matmul of the step (the quantized formats) plans its
    split of K from B * C rows (``kops.plan_rows``), so its rows' values
    do not follow R. On the card the bf16 products (``quant="none"``, a
    tied head at "none" or "fp16") run in cuBLAS at R rows, whose sums
    may round otherwise at another R: there a row's bits can follow R.
    Returns (logits (L, V), cache)."""
    recipe = layers.recipe_for(quant)
    fmt = recipe["linear"]
    b, c = token.shape
    fed, heads = rows if rows is not None else (None, None)
    packed = rows is not None and packs_layers(cfg)
    if packed:
        token = token.reshape(-1)[fed][None]
        if embeds is not None:
            embeds = embeds.reshape(-1, embeds.shape[-1])[fed][None]
            embeds_mask = embeds_mask.reshape(-1)[fed][None]
    with kops.plan_rows(None if rows is None else b * c):
        h = layers.embedding_lookup(params["embed"], token, recipe["embed"],
                                    torch.bfloat16, width=cfg.d_model)
        if embeds is not None:
            h = torch.where(embeds_mask[..., None], embeds.to(h.dtype), h)
        mrope = _mrope_decode_positions if cfg.mrope else None
        step = None
        for name, count, subs in layer_groups(cfg):
            for lp, mixer, ffn, layer_cache in _group_layers(
                    params[name], subs, cache[name]):
                if step is None and mixer != "ssm":
                    # One routing/RoPE plan for all attention layers, from
                    # the first one's K (or latent) leaf; SSM layers need
                    # none.
                    step = attn.paged_step(cfg, position, block_tables,
                                           lengths,
                                           next(iter(layer_cache.values())),
                                           c, mrope=mrope)
                    if packed:
                        step = attn.pack_step(step, fed)
                h = layer_decode(lp, cfg, h, position, layer_cache,
                                 mixer=mixer, ffn=ffn, fmt=fmt,
                                 block_tables=block_tables, lengths=lengths,
                                 paged_impl=paged_impl, step=step)
        if rows is not None:
            h = (h[0] if packed else h.reshape(-1, h.shape[-1])[fed])[heads]
        h = layers.rmsnorm_apply(params["final_norm"], h, cfg.norm_eps)
        return _lm_head(params, cfg, h, quant), cache


def lm_cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Cache shapes per layer group (leading layer axis); jamba's group
    holds one such dict per sub-layer."""
    out = {}
    for name, count, subs in layer_groups(cfg):
        shapes = []
        for mixer, _ in subs:
            shape = layer_cache_shape(cfg, mixer, batch, seq)
            shapes.append({k: (count,) + v for k, v in shape.items()})
        out[name] = shapes[0] if len(subs) == 1 else \
            {f"sub{j}": s for j, s in enumerate(shapes)}
    return out


def layer_cache_shape(cfg: ModelConfig, mixer: str, batch: int, seq: int):
    """One layer's cache shapes (no layer axis)."""
    if mixer == "gqa":
        return attn.gqa_cache_shape(cfg, batch, seq)
    if mixer == "mla":
        return attn.mla_cache_shape(cfg, batch, seq)
    return ssm.ssm_cache_shape(cfg, batch)
