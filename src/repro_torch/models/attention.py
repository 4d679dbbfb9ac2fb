"""GQA and MLA attention, ported from ``repro.models.attention``.

Full-sequence (prefill / forward) attention goes through
``chunked_attention``: on the card the hand-written flash-attention
kernel (``kernels.flash_attention``), on the CPU its plain version —
the port of the JAX package's XLA twin of its Pallas flash kernel.

A decode step attends a *chunk* of C consecutive queries per slot against
the KV cache (C == 1 is the classic one-token step; C > 1 is the unified
chunked-prefill step, in-chunk causality a per-query mask). Two caches:

* the contiguous slot arena, leaves (B, S, Hkv, D): the chunk is
  inserted at each slot's depth (``_slot_routing``) and attended by
  ``decode_attention`` (plain PyTorch, as the JAX package leaves it to
  XLA);
* the paged arena: leaves are physical pages (NP, bs, Hkv, D) and
  ``block_tables`` (B, max_blocks) int32 maps each slot's logical blocks
  to pages. Attention reads K/V through the table one of two ways
  (``paged_impl``): ``"fused"`` (default), ``kernels.paged_attention``
  — the hand-written CUDA kernel on the card, its plain version on the
  CPU; ``"ref"``, the dense gather (``paged_view``) followed by
  ``decode_attention``, the differential oracle.

The new K/V are written **in place** in both caches (the JAX engine
donates the arena to its jitted step; here the tensors are mutated).

Quantized paged cache (arena built with ``kv_quant="int8"``): each paged
leaf is a dict ``{"q": int8 code pages, "s": float16 scale pages}`` (one
scale per (position, kv-head), see ``quantize_kv``). The decode step
quantizes on insert and hands codes and scales to the fused kernel,
which dequantizes in its page walk, or dequantizes the gathered view on
the ref path.

MLA (deepseek-v3): low-rank Q/KV with a decoupled RoPE side. The cache
holds only the compressed latents, ``{"ckv": (B, S, kv_lora_rank),
"krope": (B, S, qk_rope_head_dim)}`` (pages (NP, bs, ...) on the paged
arena). Prefill expands them per head and runs the flash kernel at
D = nope + rope, Dv = v_head_dim; decode absorbs kv_b into the query and
output sides and attends the latents in place (the MLA form of
``kernels.paged_attention``, or the gather / contiguous plain paths).

M-RoPE (qwen2-vl): ``rope_tables`` builds the (cos, sin) tables from
(B, S, 3) position streams instead of (B, S) positions, and the same
``rope_rotate`` applies them. Encoder-decoder cross attention (whisper)
lives in ``models/encdec.py``: its prefill reaches ``chunked_attention``
non-causal, its decode step the plain ``decode_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (MlaPlan,
                                                 paged_decode_attention)
from repro_torch.models import flags, layers
from repro_torch.models.layers import Params
from repro_torch.parallel import sharding

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, sm_scale: float,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv).
    Returns (B, Sq, H, Dv) in q's dtype. ``q_offset``: absolute position
    of q[0] in the KV timeline (causal: key j is visible to query i iff
    j <= q_offset + i).

    The JAX package's online softmax over ``kv_chunk``-key blocks; here
    the block walk is the flash-attention kernel's (the block size does
    not change the function, so there is no ``kv_chunk``).

    On a training mesh (DTensor q) each rank attends its own (batch,
    head) block, K/V first repeated over each kv head's query heads so
    that they cut as q does (the same products)."""
    if sharding.is_dtensor(q):
        from torch.distributed.tensor.experimental import local_map
        q = sharding.evenly(q)
        b, s, h, _ = q.shape
        g = h // k.shape[2]
        if g > 1:
            k, v = (x[:, :, :, None].expand(*x.shape[:3], g, x.shape[-1])
                    .reshape(b, x.shape[1], h, x.shape[-1]) for x in (k, v))
        pl = list(q.placements)
        return local_map(
            lambda q, k, v: chunked_attention(q, k, v, causal=causal,
                                              sm_scale=sm_scale,
                                              q_offset=q_offset),
            out_placements=pl, in_placements=(pl, pl, pl),
            redistribute_inputs=True)(q, k, v)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, sm_scale=sm_scale,
                           q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     sm_scale: float, kv_len=None) -> torch.Tensor:
    """Decode-side attention: q (B, C, H, D) vs cache k/v (B, S, Hkv, D)
    in f32. ``kv_len``: None, or (B, C) valid length per query — a chunk
    passes the per-query causal depth ``pos0 + i + 1``. Under
    ``flags.mixed_intermediates()`` the cache is contracted in its
    stored dtype (q taken to it, p to V's), f32 accumulation, as the JAX
    package's."""
    b, c, h, d = q.shape
    _, s, hkv, _ = k.shape
    group = h // hkv
    # A training mesh's q (DTensor): every head on each rank of a
    # replica, which attends its own sequence block of the cache.
    q = sharding.batch_only(q)
    mixed = flags.mixed_intermediates()
    # Mixed: q taken to the cache's dtype and p to V's (f32 accumulation),
    # as the JAX package contracts the stored cache.
    qg = (q.to(k.dtype) if mixed else q).to(torch.float32).reshape(
        b, c, hkv, group, d)
    sc = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(torch.float32)) * sm_scale
    if kv_len is not None:                      # (B, C) -> (B,1,1,C,1)
        mask = torch.arange(s, device=q.device)[None, None, None, None, :] \
            < kv_len[:, None, None, :, None]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    if mixed:
        p = p.to(v.dtype).to(torch.float32)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, c, h, d).to(q.dtype)


# ----------------------------------------------------------------------
# GQA attention module (qwen3 family)
# ----------------------------------------------------------------------
def gqa_init(gen: torch.Generator, cfg: ModelConfig, fmt: str = "none") -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    p = {
        "q": layers.linear_init(gen, d, cfg.num_heads * hd, fmt,
                                bias=cfg.qkv_bias),
        "k": layers.linear_init(gen, d, cfg.num_kv_heads * hd, fmt,
                                bias=cfg.qkv_bias),
        "v": layers.linear_init(gen, d, cfg.num_kv_heads * hd, fmt,
                                bias=cfg.qkv_bias),
        "o": layers.linear_init(gen, cfg.num_heads * hd, d, fmt),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, gen.device)
        p["k_norm"] = layers.rmsnorm_init(hd, gen.device)
    return p


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) RoPE tables for (B, S) ``positions`` — for an M-RoPE
    model (B, S, 3) position streams — shared by every layer of a pass,
    at the model's rotary width (the head dim, or MLA's
    ``qk_rope_head_dim``); None for a model without RoPE."""
    if cfg.rope_theta <= 0:
        return None
    width = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
        else cfg.resolved_head_dim()
    if cfg.mrope:
        if positions.ndim != 3:
            raise ValueError("an M-RoPE model takes (B, S, 3) positions, "
                             f"got {tuple(positions.shape)}")
        return layers.mrope_cos_sin(positions, width, cfg.rope_theta,
                                    cfg.mrope_sections)
    return layers.rope_cos_sin(positions, width, cfg.rope_theta)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, fmt: str,
                 rope):
    """q, k, v (B, S, heads, D); ``rope``: (cos, sin) tables for the
    chunk's positions (``layers.rope_cos_sin``), None without RoPE.
    Under a serving mesh the projections are 'model' shards and each
    rank keeps its heads: kv-heads [m Hkv/T, (m+1) Hkv/T) and their
    query heads (contiguous, since head h reads kv-head h // G)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = (_heads(layers.linear_apply(p[n], x, fmt, gather=False), hd)
               for n in ("q", "k", "v"))
    if cfg.qk_norm:                             # qk_norm before rope
        q = layers.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        q = layers.rope_rotate(q, *rope)
        k = layers.rope_rotate(k, *rope)
    return q, k, v


def _heads(y: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd); on a training mesh the
    projection is made whole first where its cut would split a head."""
    y = sharding.heads_whole(y, y.shape[-1] // hd)
    return y.reshape(*y.shape[:2], -1, hd)


def gqa_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, rope, *,
              fmt: str = "none", causal: bool = True) -> torch.Tensor:
    """Full-sequence (forward / prefill) GQA over x (B, S, d); ``rope``:
    ``rope_tables`` of the sequence's positions."""
    return gqa_prefill(p, cfg, x, rope, fmt=fmt, causal=causal)[0]


def gqa_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, rope, *,
                fmt: str = "none", causal: bool = True):
    """Prefill returning (out, {"k", "v"}): the sequence's K/V in the JAX
    layout (B, S, Hkv, D)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(p, cfg, x, fmt, rope)
    o = chunked_attention(q, k, v, causal=causal, sm_scale=hd ** -0.5)
    o = _gather_heads(p["q"], o.reshape(b, s, -1))
    return layers.linear_apply(p["o"], o, fmt), {"k": k, "v": v}


def _gather_heads(proj: Params, o: torch.Tensor) -> torch.Tensor:
    """The attention output (..., heads * D) of every head: a rank's heads
    all-gathered over 'model' when ``proj`` (the query projection) is a
    'model' shard."""
    return sharding.gather_model(o) if sharding.is_model_shard(proj) else o


# ----------------------------------------------------------------------
# Cache plumbing: the contiguous insert, quantized KV, the paged
# block-table gather/scatter
# ----------------------------------------------------------------------
def decode_positions(position: torch.Tensor, batch: int,
                     width: int) -> torch.Tensor:
    """(B, C) absolute positions of a decode chunk: ``position`` is a
    scalar or (B,) base; chunk entry i sits at base + i."""
    base = position.to(torch.long).reshape(-1).expand(batch)
    return base[:, None] + torch.arange(width, device=position.device)


def _slot_routing(position: torch.Tensor, lengths, batch: int, seq: int,
                  width: int):
    """(pos_mat (B, C), rows (B*C,), offs (B*C,), valid (B*C,)): the slot
    and depth each chunk entry writes in the contiguous (B, S, ...)
    arena. Row b's first ``lengths[b]`` entries (all C when ``lengths``
    is None) land at ``position[b] + i``; ``position`` is a scalar or
    (B,).

    The JAX version drops the invalid entries (past a row's length, or
    past S) with a ``mode="drop"`` scatter. Torch has none, so each
    invalid entry is aimed at ``(position[b] + i) % S`` and flagged:
    ``_write`` has it carry the value already stored there, so no slot
    changes for it and no device-to-host sync finds it. Those targets
    never meet a valid entry's or each other, since a chunk is no wider
    than the cache (C <= S)."""
    pos = decode_positions(position, batch, width)           # (B, C)
    valid = pos < seq
    if lengths is not None:
        valid = valid & (torch.arange(width, device=pos.device)[None, :]
                         < lengths.to(torch.long)[:, None])
    rows = torch.arange(batch, device=pos.device)[:, None].expand(batch,
                                                                 width)
    offs = torch.where(valid, pos, pos % seq)
    return pos, rows.reshape(-1), offs.reshape(-1), valid.reshape(-1)


def _insert_kv(cache: torch.Tensor, new: torch.Tensor, position: torch.Tensor,
               lengths=None) -> torch.Tensor:
    """Write (B, C, ...) ``new`` into the (B, S, ...) ``cache`` **in
    place** through ``_slot_routing``: row b's first ``lengths[b]``
    entries (all C when ``lengths`` is None) land at ``position[b] + i``,
    the rest are dropped. Returns ``cache``."""
    b, c = new.shape[:2]
    if sharding.is_dtensor(cache):
        return _insert_kv_sharded(cache, new, decode_positions(position, b, c),
                                  lengths)
    _, rows, offs, valid = _slot_routing(position, lengths, b,
                                         cache.shape[1], c)
    _write(cache, new, rows, offs, valid)
    return cache


def _insert_kv_sharded(cache, new, pos, lengths):
    """``_insert_kv`` on a training mesh's cache (batch over the DP axes,
    sequence over 'model'): entry i of row b replaces the cache row whose
    sequence index is ``pos[b, i]`` by a masked select over each rank's
    own sequence block (an index write would gather the cut axis)."""
    seq = sharding.iota_like(cache, 1)                       # (S,)
    tail = [1] * (cache.ndim - 2)
    for i in range(new.shape[1]):
        hit = seq[None, :] == pos[:, i:i + 1]                # (B, S)
        if lengths is not None:
            hit = hit & (lengths.to(torch.long)[:, None] > i)
        cache.copy_(torch.where(hit.reshape(*hit.shape, *tail),
                                new[:, i:i + 1].to(cache.dtype), cache))
    return cache


# Scale storage dtype of quantized KV pages: fp16 (the JAX package's
# KV_QUANT_SCALE_DTYPE), so the quantized stream is (D + 2) / (2 D) of
# the bf16 stream.
KV_QUANT_SCALE_DTYPE = torch.float16


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the trailing feature axis:
    ``x`` (..., D) -> (codes int8 (..., D), scales float16 (...,)).
    The scale is amax / 127 per row; codes are round(x / scale) with the
    *f32* scale (half to even, as ``jnp.round``), clipped to +-127. Only
    the stored scale is fp16. An all-zero row maps to (codes 0, scale 0),
    which dequantizes to exactly zero."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.where(scale > 0, scale,
                                     torch.ones_like(scale))[..., None])
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale.to(KV_QUANT_SCALE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv``: f32 ``codes * scale`` with the stored
    fp16 scale widened to f32 — the fused kernel's arithmetic."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def _routing(position, block_tables, lengths, num_pages: int,
             block_size: int, width: int):
    """(pos_mat (B, C), rows (B*C,), offs (B*C,), valid (B*C,) or None):
    the page and in-page offset each chunk entry writes. Entries past a
    row's length are aimed at the null page (the last one) and flagged
    invalid; their table lookup is clamped so it never leaves the table."""
    b = block_tables.shape[0]
    pos = decode_positions(position, b, width)
    blk = torch.clamp(pos // block_size, max=block_tables.shape[1] - 1)
    rows = torch.gather(block_tables.to(torch.long), 1, blk).reshape(-1)
    valid = None
    if lengths is not None:
        valid = (torch.arange(width, device=pos.device)[None, :]
                 < lengths.to(torch.long)[:, None]).reshape(-1)
        rows = torch.where(valid, rows, torch.full_like(rows, num_pages - 1))
    return pos, rows, (pos % block_size).reshape(-1), valid


def _write(pages: torch.Tensor, new: torch.Tensor, rows, offs, valid) -> None:
    """In-place scatter of (B, C, ...) ``new`` to (rows, offs). Invalid
    entries carry the value already stored at their null-page target, so
    no page changes for them."""
    src = new.reshape(-1, *new.shape[2:]).to(pages.dtype)
    if valid is not None:
        keep = pages[rows, offs]
        src = torch.where(valid.reshape(-1, *([1] * (new.ndim - 2))), src,
                          keep)
    pages.index_put_((rows, offs), src)


def paged_insert_token(pages: torch.Tensor, new: torch.Tensor,
                       position: torch.Tensor, block_tables: torch.Tensor,
                       lengths=None) -> torch.Tensor:
    """Write (B, C, ...) ``new`` into (NP, bs, ...) ``pages`` **in place**,
    routed through ``block_tables`` (B, max_blocks): row b's first
    ``lengths[b]`` entries land at ``position[b] + i`` (all C entries when
    ``lengths`` is None).

    The JAX version scatters with ``mode="drop"``: entries past a row's
    length go out of range and are dropped. Torch has no drop mode and an
    out-of-range index on the card is a device assert, so the invalid
    entries are masked out first: they are aimed at the null page (the
    last page, never read as live KV) and carry the value already stored
    there, so no page changes for them — and no device-to-host sync is
    needed to find them. Returns ``pages``."""
    _, rows, offs, valid = _routing(position, block_tables, lengths,
                                    pages.shape[0], pages.shape[1],
                                    new.shape[1])
    _write(pages, new, rows, offs, valid)
    return pages


def paged_view(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Gather each slot's logical KV view (B, max_blocks*bs, ...) from
    (NP, bs, ...) pages. Unassigned table entries gather the null page;
    those positions sit past kv_len and are masked before the softmax."""
    v = pages[block_tables.to(torch.long)]          # (B, max_blocks, bs, ...)
    return v.flatten(1, 2)


def _paged_insert_quant(leaf: Dict, new: torch.Tensor, rows, offs,
                        valid) -> None:
    """Quantize-on-insert into a quantized paged leaf ``{"q": int8 pages,
    "s": scale pages}``, in place. Codes and scales scatter through the
    same routing, so the null-page trick covers both."""
    q, s = quantize_kv(new)
    _write(leaf["q"], q, rows, offs, valid)
    _write(leaf["s"], s, rows, offs, valid)


def _paged_view_dequant(leaf: Dict, block_tables: torch.Tensor):
    """Dense-gather oracle over a quantized paged leaf: gather codes and
    scales through the table, dequantize to the f32 logical view."""
    return dequantize_kv(paged_view(leaf["q"], block_tables),
                         paged_view(leaf["s"], block_tables))


@dataclasses.dataclass(frozen=True)
class PagedStep:
    """What a decode step derives from (position, block_tables, lengths)
    before any layer runs: the write routing (the pages, or the slot
    rows of the contiguous arena; None for a training mesh's sharded
    cache, which ``_insert_kv`` writes) and the RoPE tables. Every layer
    shares them, so ``lm_decode_step`` builds one per step
    (``paged_step``) instead of once per layer and leaf.

    ``fed``: for a packed step (``pack_step``), the (R,) flat indices
    ``slot * C + i`` of the rows the step feeds, in slot order. Its
    layers then take (1, R, ...) activations, its routing and RoPE
    tables are those rows', and only the attention core sees the (B, C)
    layout."""

    pos_mat: torch.Tensor
    rows: torch.Tensor
    offs: torch.Tensor
    valid: Optional[torch.Tensor]
    rope: Optional[tuple]
    fed: Optional[torch.Tensor] = None


def paged_step(cfg: ModelConfig, position: torch.Tensor,
               block_tables: Optional[torch.Tensor], lengths, pages,
               width: int, mrope=None) -> PagedStep:
    """The shared per-step routing and RoPE tables for a chunk of
    ``width`` entries per slot: ``pages`` is one layer's K leaf —
    (NP, bs, ...) pages (or their ``{"q", "s"}`` dict), or the contiguous
    (B, S, ...) cache when ``block_tables`` is None. ``mrope``: for an
    M-RoPE model, ``fn(cfg, pos_mat)`` giving the chunk's (B, C, 3)
    position streams."""
    if block_tables is None and sharding.is_dtensor(pages):
        pos = decode_positions(position, pages.shape[0], width)
        rows = offs = valid = None
    elif block_tables is None:                  # contiguous slot arena
        pos, rows, offs, valid = _slot_routing(position, lengths,
                                               pages.shape[0],
                                               pages.shape[1], width)
    else:
        if isinstance(pages, dict):
            pages = pages["q"]
        pos, rows, offs, valid = _routing(position, block_tables, lengths,
                                          pages.shape[0], pages.shape[1],
                                          width)
    rope = rope_tables(cfg, pos if mrope is None else mrope(cfg, pos))
    return PagedStep(pos, rows, offs, valid, rope)


def pack_step(step: PagedStep, fed: torch.Tensor) -> PagedStep:
    """``step`` on its fed rows alone: ``fed`` (R,) the flat indices
    ``slot * C + i`` of the rows with ``i < lengths[slot]``, each of
    which writes (so the packed routing needs no ``valid``). The indices
    are taken once a step here."""
    rope = None if step.rope is None else tuple(
        t.reshape(-1, *t.shape[2:])[fed][None] for t in step.rope)
    return PagedStep(step.pos_mat, step.rows[fed], step.offs[fed], None,
                     rope, fed)


def _padded(step: PagedStep, x: torch.Tensor) -> torch.Tensor:
    """A packed step's (1, R, ...) rows scattered into the (B, C, ...)
    layout the attention kernels read (zeros in the rows it does not
    feed, whose outputs nothing reads); ``x`` itself unpacked."""
    if step.fed is None:
        return x
    b, c = step.pos_mat.shape
    out = x.new_zeros((b * c,) + x.shape[2:])
    out[step.fed] = x[0]
    return out.reshape(b, c, *x.shape[2:])


def _packed(step: PagedStep, x: torch.Tensor) -> torch.Tensor:
    """The fed rows (1, R, ...) of a packed step's (B, C, ...) ``x``;
    ``x`` itself unpacked."""
    if step.fed is None:
        return x
    return x.reshape(-1, *x.shape[2:])[step.fed][None]


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               position: torch.Tensor, cache: Dict, *, fmt: str = "none",
               block_tables: Optional[torch.Tensor] = None, lengths=None,
               paged_impl: str = "fused",
               step: Optional[PagedStep] = None):
    """Decode step over a chunk of C tokens. x: (B, C, d); ``position``:
    (B,) base positions (or a scalar, contiguous cache only); cache
    {"k","v"}: the contiguous (B, S, Hkv, D) cache, or physical pages
    (NP, bs, Hkv, D) — each a ``{"q", "s"}`` dict on an int8 arena — when
    ``block_tables`` is given; updated in place. ``lengths``: (B,) valid
    entries per row — writes past a row's length are dropped and its tail
    outputs are garbage the engine never reads. ``step``: the precomputed
    ``paged_step`` for these (position, block_tables, lengths), if the
    caller shares one across layers; a packed one (``pack_step``) takes
    x (1, R, d) and gives its R fed rows' outputs. Returns (out,
    cache)."""
    if paged_impl not in ("fused", "ref"):
        raise ValueError(f"unknown paged_impl {paged_impl!r}")
    hd = cfg.resolved_head_dim()
    sm = hd ** -0.5
    if step is None:
        step = paged_step(cfg, position, block_tables, lengths, cache["k"],
                          x.shape[1])
    b, cw = step.pos_mat.shape
    q, k, v = _project_qkv(p, cfg, x, fmt, step.rope)
    q = _padded(step, q)
    kv_quant = isinstance(cache["k"], dict)      # {"q", "s"} int8 leaves
    parts = sharding.plan_parts(sharding.is_model_shard(p["q"]))
    if step.rows is None:                        # a sharded training cache
        _insert_kv(cache["k"], k, position, lengths)
        _insert_kv(cache["v"], v, position, lengths)
    else:                                        # slot rows or pages
        write = _paged_insert_quant if kv_quant else _write
        write(cache["k"], k, step.rows, step.offs, step.valid)
        write(cache["v"], v, step.rows, step.offs, step.valid)
    if block_tables is None:                     # contiguous slot arena
        o = decode_attention(q, cache["k"], cache["v"], sm_scale=sm,
                             kv_len=step.pos_mat + 1)
    elif kv_quant:
        if paged_impl == "fused":
            o = paged_decode_attention(
                q.contiguous(), cache["k"]["q"], cache["v"]["q"],
                block_tables, position, sm_scale=sm, lengths=lengths,
                k_scales=cache["k"]["s"], v_scales=cache["v"]["s"],
                plan_parts=parts)
        else:
            # The JAX ref path rounds the dequantized view to q's dtype;
            # the fused kernel does not.
            o = decode_attention(
                q, _paged_view_dequant(cache["k"], block_tables).to(q.dtype),
                _paged_view_dequant(cache["v"], block_tables).to(q.dtype),
                sm_scale=sm, kv_len=step.pos_mat + 1)
    elif paged_impl == "fused":
        o = paged_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                   block_tables, position, sm_scale=sm,
                                   lengths=lengths, plan_parts=parts)
    else:
        o = decode_attention(q, paged_view(cache["k"], block_tables),
                             paged_view(cache["v"], block_tables),
                             sm_scale=sm, kv_len=step.pos_mat + 1)
    o = _gather_heads(p["q"], _packed(step, o.reshape(b, cw, -1)))
    return layers.linear_apply(p["o"], o, fmt), cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    hd = cfg.resolved_head_dim()
    return {"k": (batch, seq, cfg.num_kv_heads, hd),
            "v": (batch, seq, cfg.num_kv_heads, hd)}


# ----------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV, decoupled RoPE, compressed cache
# ----------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ModelConfig,
             fmt: str = "none") -> Params:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_a": layers.linear_init(gen, d, m.q_lora_rank, fmt),
        "q_a_norm": layers.rmsnorm_init(m.q_lora_rank, gen.device),
        "q_b": layers.linear_init(gen, m.q_lora_rank, h * qk_dim, fmt),
        "kv_a": layers.linear_init(
            gen, d, m.kv_lora_rank + m.qk_rope_head_dim, fmt),
        "kv_a_norm": layers.rmsnorm_init(m.kv_lora_rank, gen.device),
        "kv_b": layers.linear_init(
            gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim),
            fmt),
        "o": layers.linear_init(gen, h * m.v_head_dim, d, fmt),
    }


def _mla_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, fmt: str, rope):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), ckv (B,S,rank),
    krope (B,S,rope)); ``rope``: ``rope_tables`` of the positions."""
    m = cfg.mla
    b, s, _ = x.shape
    qa = layers.rmsnorm_apply(p["q_a_norm"],
                              layers.linear_apply(p["q_a"], x, fmt),
                              cfg.norm_eps)
    # This rank's heads under a serving mesh (q_b is a 'model' shard).
    q = layers.linear_apply(p["q_b"], qa, fmt, gather=False).reshape(
        b, s, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = layers.rope_rotate(q_rope, *rope)
    kv = layers.linear_apply(p["kv_a"], x, fmt)
    ckv, krope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = layers.rmsnorm_apply(p["kv_a_norm"], ckv, cfg.norm_eps)
    krope = layers.rope_rotate(krope[:, :, None, :], *rope)[:, :, 0, :]
    return q_nope, q_rope, ckv, krope


def mla_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, rope, *,
              fmt: str = "none") -> torch.Tensor:
    """Full-sequence (forward / prefill) MLA over x (B, S, d)."""
    return mla_prefill(p, cfg, x, rope, fmt=fmt)[0]


def mla_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, rope, *,
                fmt: str = "none"):
    """Prefill returning (out, {"ckv", "krope"}): kv_b expands the
    compressed KV per head, the flash kernel attends at D = nope + rope
    (the RoPE key shared by every head) and Dv = v_head_dim, and the
    cache keeps only the compressed latents. The JAX package projects
    q/kv a second time for the cache; the values are the same."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope, ckv, krope = _mla_qkv(p, cfg, x, fmt, rope)
    h = q_nope.shape[2]                 # this rank's heads under a mesh
    kvb = layers.linear_apply(p["kv_b"], ckv, fmt, gather=False).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    sm = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o = chunked_attention(q, k, v, causal=True, sm_scale=sm)
    o = _gather_heads(p["q_b"], o.reshape(b, s, -1))
    return layers.linear_apply(p["o"], o, fmt), {"ckv": ckv, "krope": krope}


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               position: torch.Tensor, cache: Dict, *, fmt: str = "none",
               block_tables: Optional[torch.Tensor] = None, lengths=None,
               paged_impl: str = "fused",
               step: Optional[PagedStep] = None):
    """Absorbed-matmul MLA decode over a chunk of C tokens: kv_b is folded
    into the query side (q_eff = q_nope . W_k) and the output side
    (ctx . W_v), so the compressed cache is attended directly and never
    expanded. Arguments as ``gqa_decode``; cache {"ckv", "krope"}:
    contiguous (B, S, ...) leaves, or pages (NP, bs, ...) — each a
    ``{"q", "s"}`` dict on an int8 arena — written in place.

    Paged, ``paged_impl="fused"``: the MLA form of the fused kernel takes
    q_eff against the ckv pages (which are also V) and joins the RoPE
    score through its q2/k2 operands (int8 pages and (NP, bs) scales
    lifted to its Hkv == 1 layout). ``"ref"``: the dense gather and plain
    einsums; the contiguous arena takes the same plain einsums."""
    if paged_impl not in ("fused", "ref"):
        raise ValueError(f"unknown paged_impl {paged_impl!r}")
    m = cfg.mla
    b, cw = x.shape[:2]
    if step is None:
        step = paged_step(cfg, position, block_tables, lengths,
                          cache["ckv"], cw)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(p, cfg, x, fmt, step.rope)
    h = q_nope.shape[2]                 # this rank's heads under a mesh
    kv_quant = isinstance(cache["ckv"], dict)
    fused = block_tables is not None and paged_impl == "fused"
    if block_tables is None:                     # contiguous slot arena
        ckv = _insert_kv(cache["ckv"], ckv_new, position, lengths)
        krope = _insert_kv(cache["krope"], krope_new, position, lengths)
    elif kv_quant:
        _paged_insert_quant(cache["ckv"], ckv_new, step.rows, step.offs,
                            step.valid)
        _paged_insert_quant(cache["krope"], krope_new, step.rows, step.offs,
                            step.valid)
        if not fused:
            ckv = _paged_view_dequant(cache["ckv"], block_tables)
            krope = _paged_view_dequant(cache["krope"], block_tables)
    else:
        _write(cache["ckv"], ckv_new, step.rows, step.offs, step.valid)
        _write(cache["krope"], krope_new, step.rows, step.offs, step.valid)
        if not fused:
            ckv = paged_view(cache["ckv"], block_tables)
            krope = paged_view(cache["krope"], block_tables)

    wkv = layers.linear_dense_weight(p["kv_b"], fmt, dtype=torch.float32)
    wkv = wkv[:, :m.kv_lora_rank]      # drop K-quant padding columns
    wkv = wkv.reshape(h, m.qk_nope_head_dim + m.v_head_dim, m.kv_lora_rank)
    wk = wkv[:, :m.qk_nope_head_dim]                     # (h, nope, rank)
    wv = wkv[:, m.qk_nope_head_dim:]                     # (h, v, rank)
    q_eff = torch.einsum("bqhc,hcr->bqhr", q_nope.to(torch.float32), wk)
    q2 = q_rope.to(torch.float32)
    sm = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if fused:
        ckv_p, krope_p = cache["ckv"], cache["krope"]
        plan = _mla_plan(p["q_b"], position, lengths, b, cw, h)
        if kv_quant:
            ctx = paged_decode_attention(
                q_eff.contiguous(), ckv_p["q"][:, :, None, :], None,
                block_tables, position, sm_scale=sm, lengths=lengths,
                k_scales=ckv_p["s"][:, :, None], q2=q2.contiguous(),
                k2_pages=krope_p["q"][:, :, None, :],
                k2_scales=krope_p["s"][:, :, None], mla_plan=plan)
        else:
            ctx = paged_decode_attention(
                q_eff.contiguous(), ckv_p[:, :, None, :], None,
                block_tables, position, sm_scale=sm, lengths=lengths,
                q2=q2.contiguous(), k2_pages=krope_p[:, :, None, :],
                mla_plan=plan)
    else:
        # Mixed: the queries taken to the latents' dtype and p to ckv's
        # (f32 accumulation), as the JAX package contracts the cache.
        mixed = flags.mixed_intermediates()
        ckv_f = ckv.to(torch.float32)
        qe, qr = (q_eff.to(ckv.dtype).to(torch.float32),
                  q2.to(krope.dtype).to(torch.float32)) if mixed \
            else (q_eff, q2)
        sc = (torch.einsum("bqhr,bsr->bhqs", qe, ckv_f)
              + torch.einsum("bqhe,bse->bhqs", qr,
                             krope.to(torch.float32))) * sm
        mask = torch.arange(ckv.shape[1], device=x.device)[None, None, None] \
            < (step.pos_mat + 1)[:, None, :, None]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        pr = torch.softmax(sc, dim=-1)
        if mixed:
            pr = pr.to(ckv.dtype).to(torch.float32)
        ctx = torch.einsum("bhqs,bsr->bqhr", pr, ckv_f)
    o = torch.einsum("bqhr,hvr->bqhv", ctx, wv)
    o = _gather_heads(p["q_b"], o.reshape(b, cw, -1).to(x.dtype))
    return layers.linear_apply(p["o"], o, fmt), cache


def _mla_plan(q_b: Params, position: torch.Tensor, lengths, b: int,
              cw: int, h: int) -> Optional[MlaPlan]:
    """The whole call a paged MLA call on a serving mesh is a shard of:
    the whole step's positions and lengths on a 'data' replica
    (``sharding.whole_step``), every head on a 'model' shard (``q_b``
    cut: this rank's ``h`` heads are block ``q_b.index``); None on one
    device, where the call is whole."""
    whole = sharding.whole_step(b)
    cut = sharding.is_model_shard(q_b)
    if whole is None and not cut:
        return None
    if whole is None:
        pos = position.to(torch.int32).reshape(-1).expand(b).contiguous()
        lens = lengths if lengths is not None else torch.full(
            (b,), cw, dtype=torch.int32, device=position.device)
        whole = (pos, lens, 0)
    parts, index = (q_b.parts, q_b.index) if cut else (1, 0)
    return MlaPlan(whole[0], whole[1], whole[2], h * parts, h * index)


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    m = cfg.mla
    return {"ckv": (batch, seq, m.kv_lora_rank),
            "krope": (batch, seq, m.qk_rope_head_dim)}
