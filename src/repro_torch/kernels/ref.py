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


def matmul_ref(x: torch.Tensor, planes: Planes, fmt: str) -> torch.Tensor:
    """y = x @ dequantize(planes).T in f32 (dequantize, then an f32
    product)."""
    w = dequant.DEQUANTIZERS[fmt](planes)
    return x.to(torch.float32) @ w.T


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        positions: torch.Tensor, *,
                        sm_scale: float) -> torch.Tensor:
    """Paged decode attention by dense gather: each slot's logical view
    ``pages[block_tables]`` attended with the per-query causal depth
    ``positions + i + 1`` in f32 (``attention.paged_view`` followed by
    ``decode_attention``). q (B, C, H, D); pages (NP, bs, Hkv, D);
    returns (B, C, H, D) in q's dtype. Rows past a slot's valid length
    are garbage by contract, as in the kernel."""
    b, c, h, d = q.shape
    hkv = k_pages.shape[2]
    g = h // hkv
    tables = block_tables.long()
    kc = k_pages[tables].flatten(1, 2).to(torch.float32)   # (B, S, Hkv, D)
    vc = v_pages[tables].flatten(1, 2).to(torch.float32)
    s = kc.shape[1]
    qg = q.to(torch.float32).reshape(b, c, hkv, g, d)
    sc = torch.einsum("bqhgd,bshd->bhgqs", qg, kc) * sm_scale
    kv_len = positions.long()[:, None] + torch.arange(c, device=q.device) + 1
    mask = torch.arange(s, device=q.device)[None, None, None, None, :] \
        < kv_len[:, None, None, :, None]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, vc)
    return o.reshape(b, c, h, d).to(q.dtype)
