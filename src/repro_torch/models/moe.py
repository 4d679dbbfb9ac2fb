"""Mixture-of-Experts FFN (deepseek-v3, granite), ported from
``repro.models.moe``.

The same function as the JAX package's capacity-based dispatch, step for
step, because which tokens an expert drops depends on every tie rule:

* the router runs in f32; top-k is a stable descending sort, so equal
  probabilities go to the lowest expert index first (``lax.top_k``);
* the (token, k) assignments are sorted by expert with a stable argsort,
  so within an expert tokens keep their order; each expert takes the
  first ``cap = max(int(cf * t * k / E + 0.999), 4)`` of them and the
  rest are dropped (gate 0);
* every one of the t = B * S rows is routed, a chunk's garbage rows
  included (they can take capacity from later rows, as in JAX);
* expert products are bf16 weights (dequantized by
  ``core/quant/dequant.py`` in f32 and rounded once, ``_bank_dense``)
  times bf16 activations, SwiGLU in f32 rounded to bf16;
* the combine adds each token's k expert outputs in ascending slot order
  (the order of the JAX scatter-add), with no atomics, so it never varies
  from run to run.

Two things differ in how, not in what: the expert weights are dequantized
``EXPERT_GROUP_ELEMS`` elements at a time (a whole deepseek-v3 bank is
7.5 GB in bf16), and an expert whose capacity rows are all the dummy
zero row is skipped — the JAX package computes it, and its output is
exactly 0 (SwiGLU of 0 is 0). Finding those experts reads the per-expert
counts on the host: one device-to-host sync per MoE layer. The expert
products stay ``torch.bmm``, as the JAX package leaves them to XLA: no
TPU kernel computes them.

Under a serving mesh (``parallel/sharding.py``) the step's tokens are
all-gathered over 'data' at entry (``constrain_replicated``, the JAX
package's replication pin), so every replica routes the whole step and
fills capacity as one device does, and keeps its own rows at the end
(``data_rows``; the shared expert runs on those rows only). Expert
banks cut over 'model' (out-features, axis -2) compute their block of
gate/up and of down, each all-gathered before it is used whole.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import dequant, pack
from repro_torch.models import layers
from repro_torch.models.layers import Params
from repro_torch.parallel import sharding

# Expert-weight elements dequantized (and randomly drawn at init) at a
# time: 2^28 elements, 1 GiB as f32.
EXPERT_GROUP_ELEMS = 1 << 28


def _group(n_out: int, n_in: int) -> int:
    """Experts per group for (n_out, n_in) expert weights."""
    return max(1, EXPERT_GROUP_ELEMS // (n_out * n_in))


def _expert_bank(gen: torch.Generator, e: int, n_in: int, n_out: int,
                 scale: float, fmt: str) -> Params:
    """Random (E, n_out, n_in) expert weights, drawn and quantized a group
    of experts at a time into preallocated planes (E, n_out, packed):
    bf16 ``{"w"}`` for ``fmt="none"``, else the format's planes."""
    bank: Dict[str, torch.Tensor] = {}
    step = _group(n_out, n_in)
    for e0 in range(0, e, step):
        n = min(step, e - e0)
        w = torch.randn((n, n_out, n_in), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale
        planes = {"w": w.to(torch.bfloat16)} if fmt == "none" else {
            k: v.reshape(n, n_out, -1)
            for k, v in pack.quantize(w.reshape(n * n_out, n_in),
                                      fmt).items()}
        del w
        for k, v in planes.items():
            if k not in bank:
                bank[k] = torch.empty((e,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=v.device)
            bank[k][e0:e0 + n] = v
    return bank


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             fmt: str = "none") -> Params:
    e = cfg.moe
    d = cfg.d_model
    scale = d ** -0.5
    p = {
        "router": layers.linear_init(gen, d, e.num_experts, "none",
                                     scale=scale, dtype=torch.float32),
        "gate": _expert_bank(gen, e.num_experts, d, e.moe_d_ff, scale, fmt),
        "up": _expert_bank(gen, e.num_experts, d, e.moe_d_ff, scale, fmt),
        "down": _expert_bank(gen, e.num_experts, e.moe_d_ff, d, scale, fmt),
    }
    if e.num_shared_experts:
        p["shared"] = layers.swiglu_init(
            gen, d, e.num_shared_experts * e.shared_d_ff, fmt)
    return p


def _bank_dense(bank: Params, fmt: str, in_features: int,
                experts: torch.Tensor) -> torch.Tensor:
    """Planes of ``experts`` (E, out, packed...) -> (n, out, in) bf16 dense
    weights: dequantized in f32, K-quant zero padding sliced off, rounded
    once to bf16."""
    if fmt == "none":
        return bank["w"][experts]
    sel = {k: v[experts] for k, v in bank.items()}
    n, n_out = next(iter(sel.values())).shape[:2]
    w = dequant.dequantize_as({k: v.reshape(n * n_out, -1)
                               for k, v in sel.items()}, fmt, torch.bfloat16)
    return w.reshape(n, n_out, -1)[:, :, :in_features]


def route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """Top-k routing and capacity dispatch of the (t, d) rows ``xt``.

    Returns (dispatch (E * cap,) token id per expert slot, t for the dummy
    row; slot_gate (E * cap,) f32; token_slots (t, k) the slot of each
    assignment in ascending order, E * cap where it was dropped;
    group_sizes (E,); aux loss; cap)."""
    e = cfg.moe
    t = xt.shape[0]
    k = e.num_experts_per_tok
    n_exp = e.num_experts
    dev = xt.device
    logits = layers.linear_apply(p["router"], xt.to(torch.float32), "none")
    probs = torch.softmax(logits, dim=-1)                 # (t, E)
    # lax.top_k: lowest index first among equal values.
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :k], gate_i[:, :k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # Load-balance auxiliary loss (switch-style).
    density = F.one_hot(gate_i, n_exp).to(torch.float32).mean(dim=(0, 1))
    aux = n_exp * torch.sum(density * probs.mean(dim=0))

    flat_expert = gate_i.reshape(-1)                      # (t*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gate_w.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    group_sizes = torch.zeros((n_exp,), dtype=torch.long, device=dev) \
        .scatter_add_(0, sorted_expert, torch.ones_like(sorted_expert))

    cap = max(int(e.capacity_factor * t * k / n_exp + 0.999), 4)
    offsets = torch.cumsum(group_sizes, 0) - group_sizes  # (E,) exclusive
    pos_in_exp = torch.arange(t * k, device=dev) - offsets[sorted_expert]
    trash = n_exp * cap
    slot = torch.where(pos_in_exp < cap, sorted_expert * cap + pos_in_exp,
                       torch.full_like(pos_in_exp, trash))
    dispatch = torch.full((trash + 1,), t, dtype=torch.long, device=dev)
    dispatch[slot] = flat_token[order]
    slot_gate = torch.zeros((trash + 1,), dtype=torch.float32, device=dev)
    slot_gate[slot] = flat_gate[order].to(torch.float32)
    token_slots = torch.empty_like(slot)
    token_slots[order] = slot
    token_slots = torch.sort(token_slots.reshape(t, k), dim=-1).values
    return (dispatch[:-1], slot_gate[:-1], token_slots, group_sizes, aux,
            cap)


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              fmt: str = "none", every_expert: bool = False):
    """x: (B, S, d) -> ((B, S, d), load-balance aux loss).
    ``every_expert``: run every expert's product, not only those that got
    a token (a training mesh's, whose counts have no values on the
    dry-run's fake tensors; the JAX package's capacity dispatch computes
    them all)."""
    if sharding.is_dtensor(x):
        return _moe_sharded(p, cfg, x, fmt)
    e = cfg.moe
    b, s, d = x.shape
    n_exp = e.num_experts
    x_rows = x.reshape(b * s, d)
    xt = sharding.constrain_replicated(x_rows)
    t = xt.shape[0]
    dispatch, slot_gate, token_slots, group_sizes, aux, cap = route(
        p, cfg, xt)
    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype,
                                        device=xt.device)])
    xe = xt_pad[dispatch].reshape(n_exp, cap, d).to(torch.bfloat16)

    # Experts that received a token; every other expert's slots hold the
    # dummy zero row, whose output is exactly 0.
    active = torch.arange(n_exp, device=x.device) if every_expert \
        else torch.nonzero(group_sizes).flatten()
    ye = torch.zeros((n_exp, cap, d), dtype=torch.bfloat16, device=x.device)
    step = _group(e.moe_d_ff, d)
    for a0 in range(0, active.numel(), step):
        ids = active[a0:a0 + step]
        xg = xe[ids]                                      # (n, C, d)
        g = torch.bmm(xg, _bank_dense(p["gate"], fmt, d, ids).transpose(1, 2))
        u = torch.bmm(xg, _bank_dense(p["up"], fmt, d, ids).transpose(1, 2))
        h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(
            torch.bfloat16)
        del g, u
        h = _whole(p["gate"], h)
        ye[ids] = _whole(p["down"], torch.bmm(
            h, _bank_dense(p["down"], fmt, e.moe_d_ff, ids).transpose(1, 2)))

    # Combine: each token's k slot outputs times their gates, added in
    # ascending slot order (dropped assignments read the zero row).
    ye_flat = ye.reshape(n_exp * cap, d).to(torch.float32) \
        * slot_gate[:, None]
    ye_flat = torch.cat([ye_flat, torch.zeros((1, d), dtype=torch.float32,
                                              device=x.device)])
    rows = ye_flat[token_slots]                           # (t, k, d)
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    out = sharding.data_rows(out).to(x.dtype)
    if "shared" in p:
        out = out + layers.swiglu_apply(p["shared"], x_rows, fmt)
    return out.reshape(b, s, d), aux


def _moe_sharded(p: Params, cfg: ModelConfig, x, fmt: str):
    """``moe_apply`` on a training mesh (DTensors): each 'data' replica
    routes its own rows, whole over 'model', against the expert banks
    made whole over the DP axes (FSDP's all-gather) with the expert
    hidden axis cut over 'model' (TP: gate/up column blocks, down row
    blocks, whose partial sums are all-reduced); a quantized bank's
    planes are gathered whole. The load-balance loss is the mean of the
    replicas' own. The shared experts run on the DTensor rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    model = [n == "model" for n in names]
    tp = fmt == "none"
    dp = 1
    for i, m in enumerate(model):
        dp *= 1 if m else mesh.size(i)
    cut = x.shape[0] % dp == 0          # a batch too small stays whole
    rows = [Shard(0) if cut and not m else Replicate() for m in model]

    # The planes as one flat argument list: (group, plane) keys in order.
    keys = [(k, n) for k in ("router", "gate", "up", "down") for n in p[k]]
    in_pl = [rows] + [
        [Replicate()] * len(names) if k == "router" else
        [Shard(1 if k != "down" else 2) if m and tp else Replicate()
         for m in model] for k, _ in keys]

    def local(xl, *planes):
        pl: Dict[str, Params] = {}
        for (k, n), t in zip(keys, planes):
            pl.setdefault(k, {})[n] = t
        return moe_apply(pl, cfg, xl, fmt=fmt, every_expert=True)
    out_pl = [Partial() if m and tp else
              (Shard(0) if cut and not m else Replicate()) for m in model]
    aux_pl = [Partial("avg") if cut and not m else Replicate()
              for m in model]
    y, aux = local_map(
        local, out_placements=(out_pl, aux_pl), in_placements=tuple(in_pl),
        redistribute_inputs=True)(x, *(p[k][n] for k, n in keys))
    y = sharding.reduced(y)
    if "shared" in p:
        b, s, d = x.shape
        y = y + layers.swiglu_apply(p["shared"], x.reshape(b * s, d),
                                    fmt).reshape(b, s, d)
    return y, sharding.reduced(aux)


def _whole(bank: Params, y: torch.Tensor) -> torch.Tensor:
    """A bank product's output block all-gathered over 'model' when the
    bank is a 'model' shard."""
    return sharding.gather_model(y) if sharding.is_model_shard(bank) else y
