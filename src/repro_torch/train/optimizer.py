"""AdamW (plain PyTorch, no torch.optim) with grad clipping and optional
int8 gradient compression; ported from ``repro.train.optimizer``.

Moments are f32 regardless of param dtype (bf16 params + f32 state is the
production-standard mixed-precision arrangement); each update is computed
in f32 and rounded once to the param's own dtype. Non-float leaves are
left alone (their moments are f32 scalars), as in the JAX package.

Parameters, gradients and optimizer state are trees of nested dicts and
lists of tensors (the port's parameter layout); ``tree_map``,
``tree_leaves`` and ``flatten`` walk them in one fixed order.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import TrainConfig


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree in ``rest``), keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: leaf}, the path the dict keys and list indices joined by
    "/" (the JAX package's checkpoint keys for an unstacked tree)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _is_float(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def adamw_init(params) -> Dict:
    """Zero f32 moments shaped (and, for DTensor parameters on a training
    mesh, placed) as each float parameter; an f32 scalar for any other
    leaf; the int32 step."""
    def zeros(p):
        if _is_float(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros((), dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine decay, in f32, at the (int32) step."""
    s = step.to(torch.float32)
    warm = cfg.learning_rate * (s + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.learning_rate * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree) if _is_float(x)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-6), max=1.0)
    # bf16 x f32 is f32 in JAX, rounded back once.
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype)
                    if _is_float(g) else g, grads), gn


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (gradient compression for the
    cross-replica reduction; the paper's low-bit insight applied to
    training communication)."""
    gf = g.to(torch.float32)
    amax = torch.max(torch.abs(gf))
    scale = amax / 127.0
    q = torch.clamp(torch.round(gf / torch.where(scale > 0, scale, 1.0)),
                    -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def adamw_update(params, grads, state, cfg: TrainConfig):
    """Returns (new_params, new_state, metrics)."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(state["step"], cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        if not _is_float(p):
            return p, m, v
        gf = g.to(torch.float32)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        mh = m / bc1
        vh = v / bc2
        delta = lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gn, "lr": lr}
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}, metrics


def _pick(tree, i: int):
    """The ``i``-th entry of every (p, m, v) leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
