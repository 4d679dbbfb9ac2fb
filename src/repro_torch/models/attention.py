"""GQA attention for the paged decode path, ported from
``repro.models.attention``.

A decode step attends a *chunk* of C consecutive queries per slot against
the paged KV cache (C == 1 is the classic one-token step; C > 1 is the
unified chunked-prefill step, in-chunk causality a per-query mask).
Cache leaves are physical pages (NP, bs, Hkv, D) and ``block_tables``
(B, max_blocks) int32 maps each slot's logical blocks to pages. The new
K/V are written to their pages **in place** (the JAX engine donates the
arena to its jitted step; here the page tensors are simply mutated),
then attention reads K/V through the table one of two ways
(``paged_impl``):

* ``"fused"`` (default): ``kernels.paged_attention`` — the hand-written
  CUDA kernel on the card, its plain version on the CPU;
* ``"ref"``: the dense gather (``paged_view``) followed by
  ``decode_attention``, the differential oracle.

MLA, int8 KV pages, cross attention and the contiguous arena's insert
path are not ported yet (ROADMAP A15, A14, A16, A9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models import layers
from repro_torch.models.layers import Params

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     sm_scale: float, kv_len=None) -> torch.Tensor:
    """Decode-side attention: q (B, C, H, D) vs cache k/v (B, S, Hkv, D)
    in f32. ``kv_len``: None, or (B, C) valid length per query — a chunk
    passes the per-query causal depth ``pos0 + i + 1``."""
    b, c, h, d = q.shape
    _, s, hkv, _ = k.shape
    group = h // hkv
    qg = q.to(torch.float32).reshape(b, c, hkv, group, d)
    sc = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(torch.float32)) * sm_scale
    if kv_len is not None:                      # (B, C) -> (B,1,1,C,1)
        mask = torch.arange(s, device=q.device)[None, None, None, None, :] \
            < kv_len[:, None, None, :, None]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
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


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, fmt: str,
                 rope):
    """q, k, v (B, S, heads, D); ``rope``: (cos, sin) tables for the
    chunk's positions (``layers.rope_cos_sin``), None without RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = layers.linear_apply(p["q"], x, fmt).reshape(b, s, cfg.num_heads, hd)
    k = layers.linear_apply(p["k"], x, fmt).reshape(b, s, cfg.num_kv_heads, hd)
    v = layers.linear_apply(p["v"], x, fmt).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:                             # qk_norm before rope
        q = layers.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        q = layers.rope_rotate(q, *rope)
        k = layers.rope_rotate(k, *rope)
    return q, k, v


# ----------------------------------------------------------------------
# Paged cache plumbing (block-table gather/scatter)
# ----------------------------------------------------------------------
def decode_positions(position: torch.Tensor, batch: int,
                     width: int) -> torch.Tensor:
    """(B, C) absolute positions of a decode chunk: ``position`` is the (B,)
    base; chunk entry i sits at base + i."""
    base = position.to(torch.long).reshape(batch)
    return base[:, None] + torch.arange(width, device=position.device)


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


@dataclasses.dataclass(frozen=True)
class PagedStep:
    """What a paged decode step derives from (position, block_tables,
    lengths) before any layer runs: the write routing and the RoPE tables.
    Every layer shares them, so ``lm_decode_step`` builds one per step
    (``paged_step``) instead of once per layer and leaf."""

    pos_mat: torch.Tensor
    rows: torch.Tensor
    offs: torch.Tensor
    valid: Optional[torch.Tensor]
    rope: Optional[tuple]


def paged_step(cfg: ModelConfig, position: torch.Tensor,
               block_tables: torch.Tensor, lengths, pages: torch.Tensor,
               width: int) -> PagedStep:
    """The shared per-step routing and RoPE tables for (NP, bs, ...)
    ``pages`` and a chunk of ``width`` entries per slot."""
    pos, rows, offs, valid = _routing(position, block_tables, lengths,
                                      pages.shape[0], pages.shape[1], width)
    rope = layers.rope_cos_sin(pos, cfg.resolved_head_dim(),
                               cfg.rope_theta) if cfg.rope_theta > 0 else None
    return PagedStep(pos, rows, offs, valid, rope)


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               position: torch.Tensor, cache: Dict, *, fmt: str = "none",
               block_tables: torch.Tensor, lengths=None,
               paged_impl: str = "fused",
               step: Optional[PagedStep] = None):
    """Paged decode step over a chunk of C tokens. x: (B, C, d);
    ``position``: (B,) base positions; cache {"k","v"}: physical pages
    (NP, bs, Hkv, D), updated in place. ``lengths``: (B,) valid entries
    per row — writes past a row's length are dropped and its tail outputs
    are garbage the engine never reads. ``step``: the precomputed
    ``paged_step`` for these (position, block_tables, lengths), if the
    caller shares one across layers. Returns (out, cache)."""
    if paged_impl not in ("fused", "ref"):
        raise ValueError(f"unknown paged_impl {paged_impl!r}")
    b, cw = x.shape[:2]
    hd = cfg.resolved_head_dim()
    if step is None:
        step = paged_step(cfg, position, block_tables, lengths, cache["k"],
                          cw)
    q, k, v = _project_qkv(p, cfg, x, fmt, step.rope)
    _write(cache["k"], k, step.rows, step.offs, step.valid)
    _write(cache["v"], v, step.rows, step.offs, step.valid)
    if paged_impl == "fused":
        o = paged_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                   block_tables, position,
                                   sm_scale=hd ** -0.5, lengths=lengths)
    else:
        o = decode_attention(q, paged_view(cache["k"], block_tables),
                             paged_view(cache["v"], block_tables),
                             sm_scale=hd ** -0.5, kv_len=step.pos_mat + 1)
    o = o.reshape(b, cw, cfg.num_heads * hd)
    return layers.linear_apply(p["o"], o, fmt), cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    hd = cfg.resolved_head_dim()
    return {"k": (batch, seq, cfg.num_kv_heads, hd),
            "v": (batch, seq, cfg.num_kv_heads, hd)}
