"""Request/sequence abstractions for the continuous-batching runtime.

A ``Request`` is what a client submits: prompt tokens, sampling params, a
generation budget, and an arrival time (for request-stream replay). The
scheduler wraps it in a ``Sequence`` — the engine-side state machine

    QUEUED -> PREFILL -> DECODE -> DONE
               ^  |        |
               +--+--------+ preempt  (paged arena exhausted: back to QUEUED)

PREFILL streams the prompt through the *same* jitted step as decode, up
to ``chunk`` tokens per engine iteration (``fed`` tracks progress); the
step that consumes the final prompt token also samples the first
generated token, then the sequence flips to DECODE and feeds one sampled
token per step. *Every* sampled token flows through the jitted masked
decode step (no host-side prefill sampling special case).

Preemption is recompute-style: the victim's KV blocks are reclaimed and
the sequence restarts from its prompt on re-admission (greedy decodes
reproduce the same tokens; stochastic ones resample).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class SeqState(enum.Enum):
    """Sequence lifecycle states (see the module docstring's diagram)."""

    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (greedy by default)."""

    temperature: float = 0.0        # 0 -> greedy
    top_k: int = 0                  # 0 -> no top-k filter
    top_p: float = 1.0              # 1 -> no nucleus filter
    seed: int = 0


@dataclasses.dataclass
class Request:
    """A client submission: prompt, sampling params, generation budget
    and (for stream replay) an arrival offset."""

    rid: int
    tokens: np.ndarray              # (L,) int prompt, L >= 2
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_s: float = 0.0          # offset from stream start
    extras: Optional[Dict] = None   # vlm vision_embeds / encdec frames (1, ...)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if len(self.tokens) < 2:
            raise ValueError("continuous-batching runtime needs prompts of "
                             ">= 2 tokens (last prompt token is decoded)")

    @property
    def prompt_len(self) -> int:
        """Number of prompt tokens."""
        return int(len(self.tokens))


@dataclasses.dataclass
class Sequence:
    """Engine-side state of one request."""
    req: Request
    state: SeqState = SeqState.QUEUED
    slot: Optional[int] = None
    position: int = 0               # next cache index the decode step writes
    next_token: int = 0             # input token for the next decode step
    fed: int = 0                    # prompt tokens already streamed (chunked)
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = -1             # admission order (preemption priority)
    preemptions: int = 0
    # timing (stream-relative seconds)
    t_admitted: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def rid(self) -> int:
        """The underlying request's id."""
        return self.req.rid

    def context_tokens(self) -> np.ndarray:
        """The committed context: prompt followed by every recorded
        token. While decoding, the last entry is ``next_token`` (the
        token the next step feeds) — speculative proposers continue from
        exactly what the target model will see."""
        if not self.generated:
            return np.asarray(self.req.tokens, np.int64)
        return np.concatenate([np.asarray(self.req.tokens, np.int64),
                               np.asarray(self.generated, np.int64)])

    @property
    def done(self) -> bool:
        """Whether the sequence has finished generating."""
        return self.state is SeqState.DONE

    @property
    def tokens_out(self) -> int:
        """Generated tokens committed so far."""
        return len(self.generated)

    def admit(self, slot: int, now: float) -> None:
        """QUEUED -> PREFILL: bind ``slot`` and reset feed progress."""
        assert self.state is SeqState.QUEUED
        self.state = SeqState.PREFILL
        self.slot = slot
        self.t_admitted = now
        self.fed = 0
        # The prompt streams through the unified step from position 0.
        self.position = 0
        self.next_token = int(self.req.tokens[0])

    def apply_prefix_hit(self, hit: int) -> None:
        """Fast-forward a fresh admission past ``hit`` prompt positions
        whose KV the arena mapped from shared prefix-cache pages: they
        are never streamed through the step. Always leaves at least one
        prompt token to feed — the final prompt token's logits seed
        sampling, so it is re-fed even when the whole prompt is cached
        (the arena gives its block to this sequence copy-on-write)."""
        assert self.state is SeqState.PREFILL and self.fed == 0
        assert 0 < hit < self.req.prompt_len
        self.fed = hit
        self.position = hit
        self.next_token = int(self.req.tokens[hit])

    # -- chunked prompt streaming ----------------------------------------
    @property
    def prompt_remaining(self) -> int:
        """Prompt tokens not yet streamed through the unified step."""
        return self.req.prompt_len - self.fed

    def next_feed(self, chunk: int) -> int:
        """Tokens this sequence wants from the next unified step: up to
        ``chunk`` prompt tokens while ingesting, exactly 1 while
        decoding."""
        if self.state is SeqState.PREFILL:
            return min(self.prompt_remaining, chunk)
        return 1

    def feed_chunk(self, n: int) -> bool:
        """Account ``n`` prompt tokens streamed through the unified step.
        Returns True when this chunk consumed the prompt — the caller then
        flips to DECODE and records the first sampled token (record_token
        supplies the final position bump, hence the n-1)."""
        assert self.state is SeqState.PREFILL and n <= self.prompt_remaining
        self.fed += n
        done = self.fed == self.req.prompt_len
        self.position += n - 1 if done else n
        return done

    def start_decode(self) -> None:
        """PREFILL -> DECODE (the chunk that consumed the prompt also
        sampled the first token; ``record_token`` logs it)."""
        assert self.state is SeqState.PREFILL
        self.state = SeqState.DECODE

    def preempt(self) -> None:
        """Recompute-preemption: back to QUEUED, progress discarded (the
        KV blocks backing it are reclaimed, so generation restarts from
        the prompt on re-admission)."""
        assert self.state in (SeqState.PREFILL, SeqState.DECODE)
        self.state = SeqState.QUEUED
        self.slot = None
        self.position = 0
        self.next_token = 0
        self.fed = 0
        self.generated = []
        self.t_first_token = None
        self.preemptions += 1

    def record_token(self, token: int, now: float) -> None:
        """Commit one generated token; flips to DONE at the budget."""
        assert self.state is SeqState.DECODE
        if self.t_first_token is None:
            self.t_first_token = now
        self.generated.append(int(token))
        self.position += 1
        self.next_token = int(token)
        if self.tokens_out >= self.req.max_new_tokens:
            self.state = SeqState.DONE
            self.t_done = now

    # -- per-request report ---------------------------------------------
    @property
    def _t_arrival_eff(self) -> float:
        """Arrival reference. Under realtime replay admission follows
        arrival, so this is arrival_s; under virtual replay (arrivals
        fast-forwarded) admission may precede the nominal arrival — clamp
        so latencies measure service time, never go negative."""
        return min(self.req.arrival_s, self.t_admitted)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from request arrival."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self._t_arrival_eff

    @property
    def latency_s(self) -> Optional[float]:
        """End-to-end request latency, from arrival to final token."""
        if self.t_done is None:
            return None
        return self.t_done - self._t_arrival_eff
