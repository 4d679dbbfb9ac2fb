"""Whisper-style encoder/decoder (audio family; conv frontend stubbed),
ported from ``repro.models.encdec``.

The mel/conv frontend is a stub: the caller provides precomputed frame
embeddings (B, S_enc, d) that feed the encoder directly. Positions are
sinusoidal for both stacks (the JAX package's choice), so parameter
shapes stay independent of sequence length.

Parameters: ``{"embed", "enc_layers": [per-layer dict], "enc_norm",
"dec_layers": [...], "dec_norm"}``; the JAX package's ``jax.vmap``-stacked
layers become Python lists, as in ``models/lm.py``. The decoder cache is
``{"dec_layers": {"self": {"k", "v"}, "cross": {"k", "v"}}}`` with a
leading layer axis: the self K/V follow the sequence (pages on the paged
arena), the cross K/V (L, B, S_enc, Hkv, D) are a constant-size per-slot
state, written once by the admission-time encoder pass
(``encdec_encode_cross``) and never paged.

Kernels: every linear goes through ``layers.linear_apply`` (the matmul
kernels); the encoder's self attention and the prefill's causal self and
non-causal cross attention through ``attention.chunked_attention`` (the
flash kernel); the decode step's self attention through ``gqa_decode``
(the paged kernel) and its cross attention through the plain
``attention.decode_attention``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.layers import Params
from repro_torch.parallel import sharding


def sinusoid_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``positions`` (any shape, int) of the sinusoid table, f32
    (..., d): [sin(p / 10000^(2i/d)), cos(...)]. A row depends on its
    position only, so the decode step computes the rows it needs instead
    of gathering them from a ``max_seq_len``-row table."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :d]


def sinusoid_positions(seq: int, d: int, device="cpu") -> torch.Tensor:
    """The (seq, d) f32 sinusoid table."""
    return sinusoid_rows(torch.arange(seq, device=device), d)


def _mlp_init(gen: torch.Generator, d: int, d_ff: int, fmt: str) -> Params:
    return {"fc1": layers.linear_init(gen, d, d_ff, fmt, bias=True),
            "fc2": layers.linear_init(gen, d_ff, d, fmt, bias=True)}


def _mlp_apply(p: Params, x: torch.Tensor, fmt: str) -> torch.Tensor:
    """fc2(gelu(fc1(x))): ``jax.nn.gelu``'s default is the tanh
    approximation, in f32. Under a serving mesh h is gathered once,
    after the columnwise gelu (as ``layers.swiglu_apply``)."""
    h = layers.linear_apply(p["fc1"], x, fmt, gather=False)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    if sharding.is_model_shard(p["fc1"]):
        h = sharding.gather_model(h)
    return layers.linear_apply(p["fc2"], h, fmt)


def _enc_layer_init(gen, cfg: ModelConfig, fmt: str) -> Params:
    dev = gen.device
    return {"norm1": layers.layernorm_init(cfg.d_model, dev),
            "attn": attn.gqa_init(gen, cfg, fmt),
            "norm2": layers.layernorm_init(cfg.d_model, dev),
            "mlp": _mlp_init(gen, cfg.d_model, cfg.d_ff, fmt)}


def _dec_layer_init(gen, cfg: ModelConfig, fmt: str) -> Params:
    dev = gen.device
    return {"self_norm": layers.layernorm_init(cfg.d_model, dev),
            "self_attn": attn.gqa_init(gen, cfg, fmt),
            "cross_norm": layers.layernorm_init(cfg.d_model, dev),
            "cross_attn": attn.gqa_init(gen, cfg, fmt),
            "ffn_norm": layers.layernorm_init(cfg.d_model, dev),
            "mlp": _mlp_init(gen, cfg.d_model, cfg.d_ff, fmt)}


def encdec_init(gen: torch.Generator, cfg: ModelConfig,
                quant: str = "none") -> Params:
    """Random parameters on ``gen.device`` from the generator's stream."""
    recipe = layers.recipe_for(quant)
    fmt, fmt_emb = recipe["linear"], recipe["embed"]
    dev = gen.device
    return {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       fmt_emb),
        "enc_layers": [_enc_layer_init(gen, cfg, fmt)
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": layers.layernorm_init(cfg.d_model, dev),
        "dec_layers": [_dec_layer_init(gen, cfg, fmt)
                       for _ in range(cfg.num_layers)],
        "dec_norm": layers.layernorm_init(cfg.d_model, dev),
    }


def _cross_kv(p: Params, cfg: ModelConfig, enc_out: torch.Tensor, fmt: str):
    """The cross K/V (B, S_enc, Hkv, D) of one decoder layer."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    k = layers.linear_apply(p["k"], enc_out, fmt)
    v = layers.linear_apply(p["v"], enc_out, fmt)
    return (k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def _cross_attend(p: Params, cfg: ModelConfig, x: torch.Tensor, kv,
                  fmt: str) -> torch.Tensor:
    """Non-causal attention of x's queries over the cross K/V (the flash
    kernel on the card)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = layers.linear_apply(p["q"], x, fmt).reshape(b, s, cfg.num_heads, hd)
    o = attn.chunked_attention(q, kv[0], kv[1], causal=False,
                               sm_scale=hd ** -0.5)
    return layers.linear_apply(p["o"], o.reshape(b, s, cfg.num_heads * hd),
                               fmt)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           quant="none") -> torch.Tensor:
    """The encoder over ``frames`` (B, S_enc, d): (B, S_enc, d) bf16."""
    fmt = layers.recipe_for(quant)["linear"]
    _, s, d = frames.shape
    h = frames.to(torch.bfloat16) + sinusoid_positions(
        s, d, frames.device).to(torch.bfloat16)
    for lp in params["enc_layers"]:
        hn = layers.layernorm_apply(lp["norm1"], h)
        h = h + attn.gqa_apply(lp["attn"], cfg, hn, None, fmt=fmt,
                               causal=False)
        hn = layers.layernorm_apply(lp["norm2"], h)
        h = h + _mlp_apply(lp["mlp"], hn, fmt)
    return layers.layernorm_apply(params["enc_norm"], h)


def _decoder_layer(lp, cfg: ModelConfig, h: torch.Tensor,
                   enc_out: torch.Tensor, fmt: str):
    """One decoder layer over the full sequence: (h, its self and cross
    K/V)."""
    hn = layers.layernorm_apply(lp["self_norm"], h)
    mix, self_cache = attn.gqa_prefill(lp["self_attn"], cfg, hn, None,
                                       fmt=fmt)
    h = h + mix
    hn = layers.layernorm_apply(lp["cross_norm"], h)
    kv = _cross_kv(lp["cross_attn"], cfg, enc_out, fmt)
    h = h + _cross_attend(lp["cross_attn"], cfg, hn, kv, fmt)
    hn = layers.layernorm_apply(lp["ffn_norm"], h)
    h = h + _mlp_apply(lp["mlp"], hn, fmt)
    return h, self_cache, kv


def _decoder_pass(params, cfg: ModelConfig, batch: Dict, quant: str,
                  remat: str = "none"):
    """Encode, then the decoder over ``batch["tokens"]``: (h after the
    final norm, per-layer caches {"self", "cross"}; none under a
    ``remat`` policy, whose layers keep only what the backward needs)."""
    recipe = layers.recipe_for(quant)
    fmt = recipe["linear"]
    enc_out = encode(params, cfg, batch["frames"], quant=quant)
    tokens = batch["tokens"]
    h = layers.embedding_lookup(params["embed"], tokens, recipe["embed"],
                                torch.bfloat16, width=cfg.d_model)
    h = h + sinusoid_positions(tokens.shape[1], cfg.d_model,
                               tokens.device).to(h.dtype)
    caches = []
    if remat != "none":
        # The JAX package checkpoints the whole decoder layer body, with
        # no saving policy, whichever remat it is given.
        body = layers.remat(lambda lp, h: _decoder_layer(
            lp, cfg, h, enc_out, fmt)[0], "full")
        for lp in params["dec_layers"]:
            h = body(lp, h)
        return layers.layernorm_apply(params["dec_norm"], h), caches
    for lp in params["dec_layers"]:
        h, self_cache, kv = _decoder_layer(lp, cfg, h, enc_out, fmt)
        caches.append({"self": self_cache,
                       "cross": {"k": kv[0], "v": kv[1]}})
    return layers.layernorm_apply(params["dec_norm"], h), caches


def _stack(caches) -> Dict:
    """Per-layer {"self": {k, v}, "cross": {k, v}} -> the stacked layout
    with a leading layer axis."""
    return {part: {leaf: torch.stack([c[part][leaf] for c in caches])
                   for leaf in ("k", "v")} for part in ("self", "cross")}


def encdec_forward(params, cfg: ModelConfig, batch: Dict, *, quant="none",
                   remat: str = "none"):
    """batch: {"tokens": (B, S_dec), "frames": (B, S_enc, d)}. Returns
    (logits (B, S_dec, V), aux loss 0). ``remat`` (training): any policy
    but "none" checkpoints each decoder layer whole, as the JAX
    package's ``jax.checkpoint(body)`` does; the encoder keeps its
    activations."""
    h, _ = _decoder_pass(params, cfg, batch, quant, remat)
    logits = layers.embedding_logits(params["embed"], h,
                                     layers.recipe_for(quant)["embed"])
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def encdec_loss(params, cfg: ModelConfig, batch: Dict, *, quant="none",
                remat: str = "none") -> torch.Tensor:
    """Next-token cross entropy of the decoder over ``labels >= 0``."""
    logits, _ = encdec_forward(params, cfg, batch, quant=quant, remat=remat)
    return layers.cross_entropy(logits, batch["labels"])


def encdec_prefill(params, cfg: ModelConfig, batch: Dict, *, quant="none"):
    """Encode + decoder prefill: (last-token logits (B, 1, V), {"dec_layers":
    {"self": {k, v} (L, B, S_dec, Hkv, D), "cross": {k, v} (L, B, S_enc,
    Hkv, D)}})."""
    h, caches = _decoder_pass(params, cfg, batch, quant)
    logits = layers.embedding_logits(params["embed"], h[:, -1:],
                                     layers.recipe_for(quant)["embed"])
    return logits, {"dec_layers": _stack(caches)}


def encdec_encode_cross(params, cfg: ModelConfig, frames: torch.Tensor, *,
                        quant="none") -> Dict:
    """Admission-time encoder pass of the serving engine: run the encoder
    once and project every layer's cross K/V, as a cache tree shaped like
    ``encdec_cache_shapes`` whose self K/V leaves are seq-1 zero stubs;
    the engine writes it into the slot and the decoder prompt then
    streams through the decode step chunk by chunk."""
    fmt = layers.recipe_for(quant)["linear"]
    enc_out = encode(params, cfg, frames, quant=quant)
    ks, vs = zip(*(_cross_kv(lp["cross_attn"], cfg, enc_out, fmt)
                   for lp in params["dec_layers"]))
    b = frames.shape[0]
    # The self K/V stub has the arena's kv-heads: a serving mesh's rank
    # holds its block of them (the self-attention k projection's shard).
    k_proj = params["dec_layers"][0]["self_attn"]["k"]
    hkv = cfg.num_kv_heads // (k_proj.parts if sharding.is_model_shard(
        k_proj) else 1)
    zero_self = torch.zeros((cfg.num_layers, b, 1, hkv,
                             cfg.resolved_head_dim()), dtype=torch.bfloat16,
                            device=frames.device)
    return {"dec_layers": {"self": {"k": zero_self, "v": zero_self},
                           "cross": {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}}}


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                       position: torch.Tensor, cache: Dict, *, quant="none",
                       block_tables=None, lengths=None, paged_impl="fused"):
    """Decode step over a chunk of C tokens per slot. ``block_tables``:
    paged-arena tables of the decoder's self K/V (the cross K/V is a
    per-slot state, never paged); ``lengths``: (B,) valid chunk entries
    per row. The self K/V are written in place. Returns (logits (B, C,
    V), cache)."""
    recipe = layers.recipe_for(quant)
    fmt = recipe["linear"]
    b, cw = token.shape
    hd = cfg.resolved_head_dim()
    h = layers.embedding_lookup(params["embed"], token, recipe["embed"],
                                torch.bfloat16, width=cfg.d_model)
    dec = cache["dec_layers"]
    step = attn.paged_step(cfg, position, block_tables, lengths,
                           dec["self"]["k"][0], cw)
    # The JAX package gathers from a max_seq_len-row table; its gather
    # clamps an invalid tail past the table (those rows are discarded).
    rows = torch.clamp(step.pos_mat, max=cfg.max_seq_len - 1)
    h = h + sinusoid_rows(rows, cfg.d_model).to(h.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        hn = layers.layernorm_apply(lp["self_norm"], h)
        mix, _ = attn.gqa_decode(
            lp["self_attn"], cfg, hn, position,
            {k: v[i] for k, v in dec["self"].items()}, fmt=fmt,
            block_tables=block_tables, lengths=lengths,
            paged_impl=paged_impl, step=step)
        h = h + mix
        hn = layers.layernorm_apply(lp["cross_norm"], h)
        q = layers.linear_apply(lp["cross_attn"]["q"], hn, fmt)
        o = attn.decode_attention(q.reshape(b, cw, cfg.num_heads, hd),
                                  dec["cross"]["k"][i], dec["cross"]["v"][i],
                                  sm_scale=hd ** -0.5)
        h = h + layers.linear_apply(lp["cross_attn"]["o"],
                                    o.reshape(b, cw, cfg.num_heads * hd), fmt)
        hn = layers.layernorm_apply(lp["ffn_norm"], h)
        h = h + _mlp_apply(lp["mlp"], hn, fmt)
    h = layers.layernorm_apply(params["dec_norm"], h)
    return layers.embedding_logits(params["embed"], h, recipe["embed"]), cache


def encdec_cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    hd = cfg.resolved_head_dim()
    L = cfg.num_layers
    self_kv = (L, batch, seq, cfg.num_kv_heads, hd)
    cross_kv = (L, batch, cfg.encoder_seq_len, cfg.num_kv_heads, hd)
    return {"dec_layers": {"self": {"k": self_kv, "v": self_kv},
                           "cross": {"k": cross_kv, "v": cross_kv}}}
