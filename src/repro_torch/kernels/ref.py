"""Plain PyTorch versions of the port's kernels (the ``repro.kernels.ref``
counterparts).

They define what each hand-written CUDA kernel must compute: the CPU
path runs them, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequant
from repro_torch.core.quant.pack import Planes

NEG_INF = -1e30


def matmul_ref(x: torch.Tensor, planes: Planes, fmt: str, *,
               approx_cvt53: bool = False) -> torch.Tensor:
    """y = x @ dequantize(planes).T in f32 (dequantize, then an f32
    product). ``approx_cvt53`` (q3_k only) drops each sub-block scale's
    low bit first, the paper's CVT53."""
    if approx_cvt53 and fmt != "q3_k":
        raise ValueError(f"approx_cvt53 is a q3_k option; got {fmt!r}")
    w = dequant.dequantize(planes, fmt, approx_cvt53=approx_cvt53)
    return x.to(torch.float32) @ w.T


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale=None,
                  q_offset: int = 0) -> torch.Tensor:
    """Softmax attention with GQA head grouping in f32, in the model's
    layout: q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv);
    returns (B, Sq, H, Dv) in q's dtype. Head h reads kv-head
    h // (H / Hkv). Every key j < Skv exists (the JAX kernel pads K/V to
    its block and masks the padding; here there is none), and when
    ``causal`` key j is visible to query i iff j <= ``q_offset`` + i. A
    row that sees no key is 0 (the kernel's l == 0 reads as 1)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qg = q.to(torch.float32).reshape(b, sq, hkv, g, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) \
        * sm_scale
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    qi = torch.arange(sq, device=q.device)[:, None]
    vis = (ki <= q_offset + qi) if causal else (ki >= 0)
    sc = torch.where(vis, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1) * vis.any(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages,
                        block_tables: torch.Tensor,
                        positions: torch.Tensor, *, sm_scale: float,
                        k_scales=None, v_scales=None, q2=None,
                        k2_pages=None, k2_scales=None) -> torch.Tensor:
    """Paged decode attention by dense gather: each slot's logical view
    ``pages[block_tables]`` attended with the per-query causal depth
    ``positions + i + 1`` in f32 (``attention.paged_view`` followed by
    ``decode_attention``). q (B, C, H, D); pages (NP, bs, Hkv, D);
    returns (B, C, H, Dv) in q's dtype. Rows past a slot's valid length
    are garbage by contract, as in the kernel.

    int8 pages come with fp16 scale pages (NP, bs, Hkv): each gathered
    row is ``float(code) * float(scale)`` in f32, never rounded to q's
    dtype (the kernel's dequantization).

    The MLA form: ``v_pages=None`` makes the K pages (and their scales)
    V; ``q2`` (B, C, H, D2) against ``k2_pages`` (NP, bs, Hkv, D2) (and
    ``k2_scales``) adds a second score term before ``sm_scale`` (the
    decoupled-RoPE side), the gather twin of the JAX package's MLA
    kernel test."""
    b, c, h, d = q.shape
    hkv = k_pages.shape[2]
    g = h // hkv
    tables = block_tables.long()

    def view(pages, scales):                    # (B, S, Hkv, D) f32
        x = pages[tables].flatten(1, 2).to(torch.float32)
        if scales is not None:
            x = x * scales[tables].flatten(1, 2).to(torch.float32)[..., None]
        return x
    kc = view(k_pages, k_scales)
    vc = kc if v_pages is None else view(v_pages, v_scales)
    s = kc.shape[1]
    qg = q.to(torch.float32).reshape(b, c, hkv, g, d)
    sc = torch.einsum("bqhgd,bshd->bhgqs", qg, kc)
    if q2 is not None:
        q2g = q2.to(torch.float32).reshape(b, c, hkv, g, q2.shape[-1])
        sc = sc + torch.einsum("bqhgd,bshd->bhgqs", q2g,
                               view(k2_pages, k2_scales))
    sc = sc * sm_scale
    kv_len = positions.long()[:, None] + torch.arange(c, device=q.device) + 1
    mask = torch.arange(s, device=q.device)[None, None, None, None, :] \
        < kv_len[:, None, None, :, None]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, vc)
    return o.reshape(b, c, h, vc.shape[-1]).to(q.dtype)
