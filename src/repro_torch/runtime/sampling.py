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

``verify_slots`` — the speculative-decoding verification head over the
full (B, C, V) logits of a step that fed each slot's last committed
token plus up to C-1 proposed tokens: per-slot accept lengths and the
one token emitted past the accepted prefix. Greedy slots accept on an
exact argmax match (equal to the JAX head's on the same logits);
stochastic slots accept a point-mass proposal x̂ with probability q(x̂)
and otherwise draw from q with x̂ masked out, which keeps the emitted
token's law exactly q — again equal to the JAX head in distribution.
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


def _gumbel_draw(lf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A categorical draw per row of the (N, V) logits (Gumbel-max)."""
    u = torch.rand(lf.shape, generator=gen, device=lf.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.argmax(lf + gumbel, dim=-1).to(torch.int32)


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
        tok = torch.where(temperature > 0.0, _gumbel_draw(lf, gen), tok)
    return torch.where(active, tok, torch.zeros_like(tok))


def verify_slots(logits: torch.Tensor, tokens: torch.Tensor,
                 gen: torch.Generator, temperature: torch.Tensor,
                 active: torch.Tensor, *, prop_lens: torch.Tensor,
                 lengths: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, stochastic: bool = True):
    """Speculative verification over a unified chunked step's logits.

    logits: (B, C, V) — row j is the target distribution for the token
    *after* fed token j; tokens: (B, C) the fed ids, laid out per slot as
    ``[last_committed, p_1, ..., p_k]``, so the proposal verified against
    row j is ``tokens[:, j + 1]``; prop_lens: (B,) proposal counts (0 for
    prefill chunks and plain decode); lengths: (B,) fed counts.
    temperature/top_k/top_p: per-slot sampling config as in
    ``sample_slots``; ``stochastic=False`` (every slot greedy, known on
    the host) skips the filtered path — its two V-wide sorts per row.

    Returns ``(next_token (B,), accept_len (B,))`` int32: the longest
    accepted proposal prefix, and the token sampled from the row after
    it (the correction row on rejection, the bonus row on full accept,
    row ``lengths - 1`` without proposals). Greedy slots accept on a
    raw-argmax match (first index on ties; bf16 -> f32 is exact, so the
    argmax is the f32 one), so their chain is the non-speculative one."""
    b, c, v = logits.shape
    dev = logits.device
    greedy_rows = torch.argmax(logits, dim=-1).to(torch.int32)    # (B, C)
    # The proposal aligned with row j is the token fed at j + 1.
    prop = torch.cat([tokens[:, 1:].to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)],
                     dim=1)
    accept = greedy_rows == prop
    if stochastic:
        t = torch.clamp(temperature, min=1e-6)
        flat = (logits.to(torch.float32) / t[:, None, None]).reshape(b * c, v)
        lf = _filter_top_k_top_p_slots(
            flat, top_k.repeat_interleave(c), top_p.repeat_interleave(c)
        ).reshape(b, c, v)
        q_prop = torch.gather(torch.softmax(lf, dim=-1), 2,
                              prop.to(torch.long)[..., None])[..., 0]
        u = torch.rand((b, c), generator=gen, device=dev)
        accept = torch.where((temperature > 0.0)[:, None], u < q_prop,
                             accept)
    valid = torch.arange(c, device=dev)[None, :] < prop_lens[:, None]
    accept_len = torch.cumprod((accept & valid).to(torch.int32),
                               dim=1).sum(dim=1).to(torch.int32)
    row = torch.clamp(lengths - 1 - (prop_lens - accept_len), 0, c - 1
                      ).to(torch.long)
    rows = torch.arange(b, device=dev)
    nxt = greedy_rows[rows, row]
    if stochastic:
        rejected = accept_len < prop_lens
        drop = rejected[:, None] & (
            torch.arange(v, device=dev)[None, :]
            == prop[rows, row].to(torch.long)[:, None])
        lf_r = lf[rows, row]
        draw = _gumbel_draw(torch.where(drop, torch.full_like(lf_r, NEG_INF),
                                        lf_r), gen)
        nxt = torch.where(temperature > 0.0, draw, nxt)
    zero = torch.zeros_like(nxt)
    return (torch.where(active, nxt, zero),
            torch.where(active, accept_len, zero))
