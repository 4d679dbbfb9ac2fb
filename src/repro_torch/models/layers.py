"""Shared model layers (plain functions on tensors), ported from
``repro.models.layers``.

Per the paper's task partitioning (Fig. 4), RMSNorm / RoPE / embedding /
softmax are "host-side" ops: plain torch, never quantized (norm weights
stay high precision, §III.B). Linear projections route through
``linear_apply``, which speaks the quantized plane formats via
``kernels.ops.quantized_matmul``. Randomness comes from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.core.quant import dequant, pack
from repro_torch.core.quant.formats import RECIPES
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# Linear (quantization-aware)
# ----------------------------------------------------------------------
def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                fmt: str = "none", bias: bool = False,
                scale: Optional[float] = None,
                dtype=torch.bfloat16) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_out, d_in), generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    p = quantize_linear_weight(w, fmt, dtype)
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def quantize_linear_weight(w: torch.Tensor, fmt: str,
                           dtype=torch.bfloat16) -> Params:
    if fmt == "none":
        return {"w": w.to(dtype)}
    return dict(pack.quantize(w, fmt))


def linear_apply(p: Params, x: torch.Tensor, fmt: str = "none", *,
                 gather: bool = True) -> torch.Tensor:
    """y = x @ W^T (+ b). ``p`` a ``sharding.ModelShard`` (a serving
    mesh's out-feature shard): the kernel computes this rank's output
    block, planned as the unsharded call, and the blocks are all-gathered
    over 'model' — or, with ``gather=False`` (attention's per-head
    projections), kept, with the bias's matching block."""
    shard = sharding.is_model_shard(p)
    if fmt == "none":
        if sharding.is_dtensor(x):
            # A training mesh: the weight's in-features gathered (FSDP),
            # a batched product over x's leading dim (so that its cut
            # batch and sequence dims are never merged into one) and its
            # pending sums reduced, so the rows stay cut as x's are.
            wt = sharding.feature_whole(p["w"]).to(x.dtype).T
            y = torch.bmm(x, wt.expand(x.shape[0], *wt.shape)) \
                if x.ndim == 3 else x @ wt
            y = sharding.reduced(y)
            return y + p["b"].to(y.dtype) if "b" in p else y
        w = p["w"].to(x.dtype).T
        y = kops.planned_rows(x.reshape(-1, x.shape[-1]),
                              lambda a: a @ w).reshape(*x.shape[:-1], -1)
    else:
        y = kops.quantized_matmul(x, {k: v for k, v in p.items() if k != "b"},
                                  fmt, out_dtype=x.dtype,
                                  plan_parts=sharding.plan_parts(shard))
    if shard and gather:
        y = sharding.gather_model(y)
    if "b" in p:
        b = p["b"]
        if shard and not gather:
            b = b.reshape(p.parts, -1)[p.index]
        y = y + b.to(y.dtype)
    return y


def linear_dense_weight(p: Params, fmt: str,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """The (out, in) dense weight, dequantized for a quantized format
    (K-quant padding columns included: the caller slices them off). The
    MLA absorbed decode reads kv_b this way, in per-head block form (a
    ``sharding.ModelShard``'s rows: this rank's heads)."""
    if fmt == "none":
        return p["w"].to(dtype)
    return dequant.dequantize_as({k: v for k, v in p.items() if k != "b"},
                                 fmt, dtype)


# ----------------------------------------------------------------------
# Norms ("host-side": always high precision)
# ----------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * g in f32, cast back to x's dtype."""
    y = F.rms_norm(x.to(torch.float32), (x.shape[-1],), p["g"], eps)
    return y.to(x.dtype)


def layernorm_init(d: int, device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * g + b in f32 (population
    variance), cast back to x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# Embedding (quantizable table; lookup is host-side gather + dequant)
# ----------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   fmt: str = "none", dtype=torch.bfloat16) -> Params:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    if fmt == "none":
        return {"w": w.to(dtype)}
    return dict(pack.quantize(w, fmt))


def embedding_lookup(p: Params, tokens: torch.Tensor, fmt: str = "none",
                     dtype=torch.bfloat16, width: int = 0) -> torch.Tensor:
    """Gather rows, dequantizing just the gathered rows for quant formats.
    ``width``: original embedding width (dequant may return K-quant padded
    rows; sliced back here)."""
    if sharding.is_dtensor(tokens):
        # On a training mesh the table's feature axis is gathered first
        # (FSDP), so the rows come out cut as the tokens are.
        p = {k: sharding.feature_whole(v) for k, v in p.items()}
    if fmt == "none" or fmt == "fp16":
        # Gather, then cast: the same values as casting the whole table
        # first, without converting every row of it on every step.
        return p["w"][tokens].to(dtype)
    flat_ids = tokens.reshape(-1).long()
    gathered = {k: v[flat_ids] for k, v in p.items()}
    flat = dequant.DEQUANTIZERS[fmt](gathered)
    if width:
        flat = flat[..., :width]
    d = flat.shape[-1]
    return flat.reshape(*tokens.shape, d).to(dtype)


def embedding_logits(p: Params, x: torch.Tensor,
                     fmt: str = "none") -> torch.Tensor:
    """Tied lm_head: logits = x @ E^T (offloadable dot product)."""
    if fmt == "none" or fmt == "fp16":
        w = p["w"].to(x.dtype).T
        return kops.planned_rows(x.reshape(-1, x.shape[-1]),
                                 lambda a: a @ w).reshape(*x.shape[:-1], -1)
    return kops.quantized_matmul(x, p, fmt, out_dtype=x.dtype)


# ----------------------------------------------------------------------
# RoPE (host-side)
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) tables for ``rope_rotate``, each (B, S, 1, D) f32, for
    positions (B, S) int: cos repeated over both halves, sin negated on
    the first half."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # (D/2,)
    return _cos_sin(positions[..., None].to(torch.float32) * freqs)


def mrope_cos_sin(positions_3d: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]):
    """Qwen2-VL M-RoPE tables for ``rope_rotate``: positions_3d (B, S, 3)
    = (temporal, height, width); the D/2 rotary channels are split into
    ``sections`` (summing to D/2), each rotated by its own position
    stream (``repro.models.layers.apply_mrope``)."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    dev = positions_3d.device
    freqs = rope_freqs(head_dim, theta, dev)                 # (D/2,)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=dev)   # (D/2,)
    pos = positions_3d.to(torch.float32)[..., sec_id]        # (B, S, D/2)
    return _cos_sin(pos * freqs)


def _cos_sin(ang: torch.Tensor):
    """(cos, sin) tables (B, S, 1, D) of angles (B, S, D/2)."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, D) by ``rope_cos_sin`` tables: halves (x1, x2)
    become (x1*cos - x2*sin, x2*cos + x1*sin), the same products and sums
    as the JAX package's, in fewer launches."""
    xf = x.to(torch.float32)
    x1, x2 = xf.chunk(2, dim=-1)
    out = xf * cos + torch.cat([x2, x1], dim=-1) * sin
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    return rope_rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """x: (B, S, H, D); positions_3d: (B, S, 3) int."""
    return rope_rotate(x, *mrope_cos_sin(positions_3d, x.shape[-1], theta,
                                         sections))


# ----------------------------------------------------------------------
# SwiGLU MLP (gate/up/down are offloadable dot products)
# ----------------------------------------------------------------------
def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                fmt: str = "none") -> Params:
    return {
        "gate": linear_init(gen, d, d_ff, fmt),
        "up": linear_init(gen, d, d_ff, fmt),
        "down": linear_init(gen, d_ff, d, fmt),
    }


def swiglu_apply(p: Params, x: torch.Tensor, fmt: str = "none") -> torch.Tensor:
    """down(silu(gate(x)) * up(x)). Under a serving mesh a rank computes
    its block of the d_ff axis (gate, up and the elementwise product are
    columnwise) and gathers h once before down, whose contraction needs
    all of it: one all-gather where gathering gate and up would be two."""
    g = linear_apply(p["gate"], x, fmt, gather=False)
    u = linear_apply(p["up"], x, fmt, gather=False)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    if sharding.is_model_shard(p["gate"]):
        h = sharding.gather_model(h)
    return linear_apply(p["down"], h, fmt)


def recipe_for(quant: str) -> Dict[str, str]:
    return RECIPES.get(quant, RECIPES["fp16"]) if quant != "none" else {
        "linear": "none", "embed": "none", "norm": "fp16"}


# ----------------------------------------------------------------------
# Rematerialization (training)
# ----------------------------------------------------------------------
# The products whose outputs ``"dots_saveable"`` keeps (JAX's
# ``checkpoint_policies.dots_saveable``: dot_general outputs).
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the remat policy of the JAX package's scanned layer
    body (``jax.checkpoint``): "none" keeps every activation; "full"
    keeps only the inputs and recomputes the body in the backward
    (``torch.utils.checkpoint``); "dots_saveable" keeps the products'
    outputs and recomputes the rest (selective checkpointing). The
    function is the same under each; only memory and recompute move."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots_saveable":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}: none, full or "
                     "dots_saveable")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over the positions with ``labels >=
    0`` (f32 log-sum-exp minus the gold logit; the JAX loss's masked
    mean, which divides by at least 1)."""
    lf = logits.to(torch.float32)
    idx = labels.clamp(min=0).long()[..., None]
    if sharding.is_dtensor(lf):
        # A training mesh's vocab-sharded logits: the log-sum-exp from
        # per-block maxima and sums, the gold logit as a masked sum over
        # each rank's vocab block (a whole-vocab row, or a gather and its
        # whole-vocab scatter, would be gathered on every rank).
        whole = sharding.reduced
        m = whole(lf.detach().amax(dim=-1, keepdim=True))
        logz = (m + torch.log(whole(torch.exp(lf - m).sum(
            -1, keepdim=True))))[..., 0]
        hit = idx == sharding.iota_like(lf, -1)
        gold = whole(torch.where(hit, lf, torch.zeros_like(lf)).sum(-1))
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, idx)[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
