"""Speculative decoding: proposers, accept-rate control, draft plumbing,
ported from ``repro.runtime.speculative``.

Decode is bound by moving weights (the paper's §V.A): the quantized
linear weights stream once per unified step, so weight-stream bytes per
generated token follow steps per token. Speculation proposes k tokens per
decoding slot and verifies them all in ONE unified ``(slots, chunk)``
step — the step already computes every fed position's logits, so it *is*
a verifier (``sampling.verify_slots``) — and every accepted token shares
the step's weight stream.

Two proposers behind one duck-typed interface (``propose`` is the only
method the engine requires per step; lifecycle hooks are optional):

* ``NGramProposer`` — model-free prompt lookup: match the longest recent
  n-gram of a sequence's context against an earlier occurrence and
  propose its continuation. Host-only numpy, copied from the JAX package.
* ``DraftModelProposer`` — a small draft model running greedy chunked
  decode over its OWN contiguous ``KVArena`` on the engine's device, with
  its OWN transfer ledger account.

Both are deterministic (point-mass draft distributions), so the
verification head keeps the target distribution exactly. ``SpecController``
(copied) adapts each slot's depth from an accept-rate EMA; the scheduler
funds speculative lanes last (``Scheduler.plan_feeds``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.parallel import sharding
from repro_torch.runtime.kvcache import KVArena
from repro_torch.runtime.request import Sequence
from repro_torch.runtime.transfers import TransferLedger

SPEC_MODES = ("off", "ngram", "draft")
# Families whose decode state is not purely seq-indexed KV: an SSM/conv
# recurrence advanced by a rejected token cannot be rolled back without
# recomputation, so speculation refuses them up front.
RECURRENT_FAMILIES = ("ssm", "hybrid")
# Families whose decode is conditioned on per-request modality state
# (encoder frames, vision embeds) a text-only draft pass cannot supply —
# a draft from one of these would propose from zeroed cross state.
CONDITIONED_FAMILIES = ("encdec", "vlm")


class NGramProposer:
    """Model-free prompt-lookup drafting.

    Find the longest n-gram (``max_n`` down to ``min_n``) ending the
    context that also occurs earlier, and propose the k tokens that
    followed its most recent earlier occurrence. No device work, no
    transfers, no second checkpoint."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, seqs: Dict[int, Sequence],
                grants: Dict[int, int]) -> Dict[int, np.ndarray]:
        """Per-slot proposals (possibly empty) for the granted depths."""
        out = {}
        for slot, k in grants.items():
            out[slot] = self._propose_one(seqs[slot].context_tokens(), k)
        return out

    def _propose_one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        none = np.zeros((0,), np.int32)
        if k <= 0 or len(ctx) < self.min_n + 1:
            return none
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            gram = ctx[-n:]
            # windows[i] == ctx[i:i+n]; exclude the final (query) window.
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)[:-1]
            hits = np.flatnonzero((windows == gram).all(axis=1))
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n          # most recent continuation
            cont = ctx[start:start + k]
            if cont.size:
                return cont.astype(np.int32)
        return none


@dataclasses.dataclass
class SpecController:
    """Per-slot speculation-depth controller.

    Tracks an accept-rate EMA per slot and scales the proposal depth
    between 1 and ``k_max``: a stream that stops accepting decays to
    shallow (cheap) speculation, a stream on a roll climbs back. Fresh
    admissions start optimistic (full depth)."""
    k_max: int
    decay: float = 0.7          # EMA weight on history
    adaptive: bool = True
    ema: Dict[int, float] = dataclasses.field(default_factory=dict)

    def reset(self, slot: int) -> None:
        """Forget ``slot``'s history (slot reuse by a new sequence)."""
        self.ema.pop(slot, None)

    def depth(self, slot: int) -> int:
        """Proposal depth to request for ``slot`` this step."""
        if not self.adaptive:
            return self.k_max
        e = self.ema.get(slot, 1.0)
        return max(1, min(self.k_max, round(e * self.k_max)))

    def update(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verification outcome into ``slot``'s accept EMA."""
        if proposed <= 0:
            return
        rate = accepted / proposed
        self.ema[slot] = self.decay * self.ema.get(slot, 1.0) \
            + (1.0 - self.decay) * rate


class DraftModelProposer:
    """Small-model drafting over a mirrored slot arena.

    The draft model runs greedy chunked decode on its own contiguous
    ``KVArena`` sized like the target's slot axis, on ``device``. Per
    engine step it (1) streams each speculating slot's newly committed
    tokens into the draft cache (catch-up), (2) rolls k tokens forward,
    then (3) rewinds its cache depth to the verified prefix next round
    (rejected draft KV is masked stale state, rewritten before any read —
    the *target* arena is the one held to the bit-identical rollback
    contract).

    The JAX proposer runs a round as ONE jitted dispatch: the catch-up
    feed, then a ``lax.scan`` of single-token passes. Eager PyTorch has no
    scan, so a round here is ``1 + rolls`` eager ``decode_step`` calls;
    the greedy tokens stay on the device between passes and the proposal
    matrix is read back once per round. ``steps`` counts rounds (the JAX
    dispatches), ``passes`` the model passes. All draft transfers are
    charged to ``self.ledger``, exactly as the JAX proposer charges them.
    With ``mesh`` set, the draft's parameters arrive sharded over the
    serving mesh's 'model' axis (the engine cuts them) and its arena
    holds this rank's kv-heads; every 'data' replica drafts every slot
    (the rounds run under the mesh's activation scope, not data-local),
    so the proposals agree on every rank without a collective."""

    def __init__(self, model, params, *, num_slots: int, max_seq: int,
                 chunk: int, quant: str = "none",
                 cache_dtype=torch.bfloat16, device="cuda", mesh=None):
        if model.cfg.family in RECURRENT_FAMILIES:
            raise ValueError(
                f"draft model family {model.cfg.family!r} is recurrent — "
                "its state cannot be rolled back after rejection")
        if model.cfg.family in CONDITIONED_FAMILIES:
            raise ValueError(
                f"draft model family {model.cfg.family!r} needs "
                "per-request conditioning (encoder frames / vision "
                "embeds) the proposer cannot provide — it would draft "
                "from zeroed cross state; use a decoder-only draft")
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.chunk = max(2, chunk)
        self.quant = quant
        self.device = torch.device(device)
        self.dp, self.tp = sharding.serving_degrees(mesh)
        self.arena = KVArena(model, num_slots, max_seq, dtype=cache_dtype,
                             device=self.device, mesh=mesh)
        self.reset_run()

    # -- lifecycle hooks -------------------------------------------------
    def reset_run(self) -> None:
        """Fresh ledger + slot state for a new serve() run (the arena's
        storage stays). The engine calls this BEFORE it builds the run's
        telemetry ``StepTimeline``, which then taps this fresh ledger —
        so the timeline's per-step draft deltas close against this
        account's ``breakdown()``."""
        self.ledger = TransferLedger(self.model.cfg, self.quant, dp=self.dp,
                                     tp=self.tp)
        self.steps = 0
        self.passes = 0
        # Committed context length the draft has verified-and-ingested,
        # and the speculative tail (proposal tokens already in its cache).
        self._depth = [0] * self.num_slots
        self._tail: List[List[int]] = [[] for _ in range(self.num_slots)]

    def reset_slot(self, slot: int) -> None:
        """Target admission reused this slot: drop the previous
        occupant's draft state (stale KV is masked by kv_len)."""
        self._depth[slot] = 0
        self._tail[slot] = []
        self.arena.reset_slot(slot)

    # -- proposal --------------------------------------------------------
    def _sync(self, slot: int, ctx: np.ndarray) -> None:
        """Reconcile the draft cache with the committed context: the
        accepted proposal prefix stays (it equals what the target
        committed), the rejected tail is rewound (depth rollback — the
        stale KV is rewritten before any read)."""
        depth, tail = self._depth[slot], self._tail[slot]
        keep = 0
        while keep < len(tail) and depth + keep < len(ctx) \
                and tail[keep] == int(ctx[depth + keep]):
            keep += 1
        self._depth[slot] = depth + keep
        self._tail[slot] = []

    def _greedy(self, logits: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
        return torch.where(active, torch.argmax(logits, dim=-1)
                           .to(torch.int32), torch.zeros_like(
                               active, dtype=torch.int32))

    def _dispatch(self, tokens, pos0, lens, active, rolls: int):
        """One proposal round: a chunked feed whose last valid position's
        greedy token is proposal 1, then ``rolls`` single-token greedy
        feedback passes (proposals 2..). Lanes needing fewer rolls keep
        rolling; their surplus tokens are dropped on the host and their
        surplus KV writes land past the tracked tail, where the next
        round's feed rewrites them before any read (or past ``max_seq``,
        where they are dropped). Returns the (num_slots, 1 + rolls)
        proposal matrix on the host — the round's one read-back."""
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        tok, pos, ln, act = put(tokens), put(pos0), put(lens), put(active)
        m, cache = self.model, self.arena.buffers
        logits, _ = m.decode_step(self.params, tok, pos, cache,
                                  quant=self.quant, lengths=ln)
        idx = torch.clamp(ln.to(torch.long) - 1, min=0)
        nxt = self._greedy(
            logits[torch.arange(self.num_slots, device=self.device), idx],
            act)
        props = [nxt]
        feed_len = act.to(torch.int32)        # inactive lanes write nothing
        pos = pos + ln
        for _ in range(rolls):
            lg, _ = m.decode_step(self.params, nxt[:, None], pos, cache,
                                  quant=self.quant, lengths=feed_len)
            nxt = self._greedy(lg[:, 0], act)
            props.append(nxt)
            pos = pos + 1
        self.steps += 1
        self.passes += 1 + rolls
        return torch.stack(props, dim=1).cpu().numpy()

    def propose(self, seqs: Dict[int, Sequence],
                grants: Dict[int, int]) -> Dict[int, np.ndarray]:
        """Batched drafting, one round per step: every speculating slot's
        catch-up tokens ride a chunked feed whose final logits emit
        proposal 1, and the rolls follow on the device. (Only a sequence
        whose committed backlog exceeds a whole chunk — a first proposal
        after a long prompt, or re-admission after preemption — pays
        extra catch-up rounds first.)"""
        ctxs = {s: seqs[s].context_tokens() for s in grants}
        for slot, ctx in ctxs.items():
            self._sync(slot, ctx)
        # Per-lane committed catch-up queues. The final token of each
        # queue is consumed by the proposal round itself (its logits seed
        # the roll), so catch-up always leaves at least one token pending.
        pending = {s: [int(t) for t in ctxs[s][self._depth[s]:]]
                   for s in grants}
        ns = self.num_slots
        while any(len(p) > self.chunk for p in pending.values()):
            tokens = np.zeros((ns, self.chunk), np.int32)
            pos0 = np.zeros((ns,), np.int32)
            lens = np.zeros((ns,), np.int32)
            active = np.zeros((ns,), bool)
            for s in grants:
                n = min(len(pending[s]) - 1, self.chunk)
                if n <= 0:
                    continue
                tokens[s, :n] = pending[s][:n]
                pending[s] = pending[s][n:]
                pos0[s] = self._depth[s]
                lens[s] = n
                active[s] = True
                self._depth[s] += n
            self._dispatch(tokens, pos0, lens, active, 0)
            self.ledger.charge_step_weights()         # shared linear pass
            for s in grants:
                if lens[s]:
                    self.ledger.charge_chunk("decode", int(lens[s]),
                                             int(pos0[s]) + int(lens[s]))
        # The proposal round: feed the rest of every lane's committed
        # tokens, roll the deepest lane's extra passes. Lanes wanting
        # fewer proposals than the deepest lane drop their surplus here.
        rolls = max(grants.values()) - 1
        tokens = np.zeros((ns, self.chunk), np.int32)
        pos0 = np.zeros((ns,), np.int32)
        lens = np.zeros((ns,), np.int32)
        active = np.zeros((ns,), bool)
        for s in grants:
            n = len(pending[s])
            tokens[s, :n] = pending[s]
            pos0[s] = self._depth[s]
            lens[s] = n
            active[s] = n > 0
            self._depth[s] += n
        props_mat = self._dispatch(tokens, pos0, lens, active, rolls)
        # Ledger (the JAX proposer's charges): 1 + rolls model passes,
        # each streaming the shared linear weights once; per-lane
        # activation chunks are charged only while that lane still needs
        # proposals, and each proposal is drained once.
        self.ledger.charge_step_weights()
        props: Dict[int, np.ndarray] = {}
        for s in grants:
            if not active[s]:
                props[s] = np.zeros((0,), np.int32)
                continue
            k = grants[s]
            self.ledger.charge_chunk("decode", int(lens[s]),
                                     int(pos0[s]) + int(lens[s]))
            lane = props_mat[s, :k].astype(np.int32)
            props[s] = lane
            # Fed-back proposals (all but the last) extend the tracked
            # tail: they are real cache contents the next _sync matches
            # against the target's commit.
            self._tail[s].extend(int(t) for t in lane[:-1])
            for _ in range(k):
                self.ledger.charge_sampled()          # proposal drained d2h
        for i in range(rolls):
            self.ledger.charge_step_weights()
            for s in grants:
                if active[s] and i < grants[s] - 1:
                    p = int(pos0[s]) + int(lens[s]) + i
                    self.ledger.charge_chunk("decode", 1, p + 1)
        return props


def make_proposer(mode: str, *, draft_model=None, draft_params=None,
                  num_slots: int = 0, max_seq: int = 0, chunk: int = 0,
                  quant: str = "none", cache_dtype=torch.bfloat16,
                  device="cuda", mesh=None):
    """Build the proposer for ``mode`` ("ngram" or "draft")."""
    if mode == "ngram":
        return NGramProposer()
    if mode == "draft":
        if draft_model is None or draft_params is None:
            raise ValueError("spec='draft' needs spec_draft_model and "
                             "spec_draft_params")
        return DraftModelProposer(draft_model, draft_params,
                                  num_slots=num_slots, max_seq=max_seq,
                                  chunk=chunk, quant=quant,
                                  cache_dtype=cache_dtype, device=device,
                                  mesh=mesh)
    raise ValueError(f"unknown spec mode {mode!r} (choose from "
                     f"{SPEC_MODES})")
