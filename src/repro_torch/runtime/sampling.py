"""Token sampling for the serving step, ported from ``repro.runtime.sampling``
(paper-faithful: the final softmax/sampling stays "host-side" plain ops,
never offloaded or quantized).

``sample_slots`` — the fused masked sampler over the fixed slot axis:
per-slot temperature, top_k and top_p *vectors* plus an active mask.
Greedy slots take ``torch.argmax``, which returns the first maximal
index like ``jnp.argmax`` — bf16 logits over a 151936-token vocabulary
do tie. Stochastic slots draw from a ``torch.Generator`` on the logits'
device (Gumbel-max over the filtered logits, i.e. a categorical draw);
its numbers differ from ``jax.random``'s, so stochastic streams agree
with the JAX package in distribution, not token for token.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _filter_top_k_top_p_slots(lf: torch.Tensor, top_k: torch.Tensor,
                              top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot top-k/top-p filters over (B, V) logits with (B,)
    parameters. top_k == 0 / top_p == 1 disable the filter for that slot."""
    v = lf.shape[-1]
    neg = torch.full_like(lf, NEG_INF)
    # top-k: threshold at the k-th largest value of each row.
    sorted_k = torch.sort(lf, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.to(torch.long) - 1, 0, v - 1)
    kth = torch.gather(sorted_k, 1, k_idx[:, None])
    lf = torch.where((top_k > 0)[:, None] & (lf < kth), neg, lf)
    # top-p over the (possibly top-k-filtered) distribution.
    sorted_p = torch.sort(lf, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_p, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cum < top_p[:, None]).sum(-1, keepdim=True),
                             max=v - 1)
    cutoff = torch.gather(sorted_p, 1, cutoff_idx)
    return torch.where((top_p < 1.0)[:, None] & (lf < cutoff), neg, lf)


def sample_slots(logits: torch.Tensor, gen: torch.Generator,
                 temperature: torch.Tensor, active: torch.Tensor, *,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 stochastic: bool = True) -> torch.Tensor:
    """Fused per-slot sampling for the serving step.

    logits: (B, V); temperature: (B,) — 0 selects greedy per slot;
    active: (B,) bool — inactive slots emit token 0; top_k/top_p: (B,).
    ``stochastic=False`` (every slot greedy, known on the host) skips the
    filtered draw."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if stochastic:
        t = torch.clamp(temperature, min=1e-6)[:, None]
        lf = _filter_top_k_top_p_slots(logits.to(torch.float32) / t,
                                       top_k, top_p)
        u = torch.rand(lf.shape, generator=gen, device=lf.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
        draw = torch.argmax(lf + gumbel, dim=-1).to(torch.int32)
        tok = torch.where(temperature > 0.0, draw, tok)
    return torch.where(active, tok, torch.zeros_like(tok))
