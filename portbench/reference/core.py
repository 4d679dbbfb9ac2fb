"""Plain float32 building blocks of the reference models.

No kernel, no cache, no batching: each sequence is run whole, one layer
at a time, with TF32 off so that a float32 product is a float32 product.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32 (TF32 off), restored on exit."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (L, H, D) at positions 0..L-1, the halves
    (x1, x2) rotated as (x1 cos - x2 sin, x2 cos + x1 sin)."""
    L, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, block: int = 256) -> torch.Tensor:
    """softmax(q k^T * scale + causal mask) v, q (L, H, Dk), k (L, Hk, Dk),
    v (L, Hk, Dv), H a multiple of Hk (query head h reads kv head
    h // (H / Hk)); computed in blocks of query rows. Returns (L, H, Dv)."""
    L, H, _ = q.shape
    g = H // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, L, Dk)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, L, Dv)
    out = torch.empty((L, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for r0 in range(0, L, block):
        r1 = min(L, r0 + block)
        s = torch.einsum("qhd,hkd->hqk", q[r0:r1], kk[:, :r1]) * scale
        keep = torch.arange(r1, device=q.device)[None, :] \
            <= torch.arange(r0, r1, device=q.device)[:, None]
        s = torch.where(keep[None], s, torch.full_like(s, float("-inf")))
        p = torch.softmax(s, dim=-1)
        out[r0:r1] = torch.einsum("hqk,hkd->qhd", p, vv[:, :r1])
    return out


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg.T) * (x @ wu.T)) @ wd.T


def head_logits(h: torch.Tensor, w: torch.Tensor,
                on_logits: Callable[[int, torch.Tensor], None],
                block: int = 512) -> None:
    """Logits of the rows of h, handed on a block of rows at a time
    (row offset, (n, vocab) float32)."""
    for r0 in range(0, h.shape[0], block):
        on_logits(r0, h[r0:r0 + block] @ w.T)
