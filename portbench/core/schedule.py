"""What each step of a serve did, rebuilt from the engine's step events.

The engine's telemetry (``runtime.telemetry.StepTimeline``) closes every
step with an event: its host-clock start and end (seconds from the start
of ``serve``), the slots in use, cumulative counters as per-step deltas,
and the slot mix, one ``(slot, rid, kind, fed, emitted)`` per slot. From
these and the requests' prompt lengths this module rebuilds, for every
step, each slot's position and context, the time of every output token,
and the tokens each request took from the prefix cache.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Feed:
    """One slot's share of a step."""

    slot: int
    rid: int
    kind: str            # prefill | decode | verify
    n: int               # tokens fed
    emitted: int         # tokens committed by this step
    pos0: int            # position of the first fed token


@dataclasses.dataclass
class Step:
    index: int
    t_start: float
    t_end: float
    occupancy: int
    counters: Dict[str, float]
    feeds: List[Feed]

    @property
    def emitted(self) -> int:
        return sum(f.emitted for f in self.feeds)


class Schedule:
    """Steps of one serve with their feeds placed at their positions.

    ``prompt_len``: rid -> prompt length."""

    def __init__(self, events, prompt_len: Dict[int, int]):
        self.preemptions = 0
        total_prefill: Dict[int, int] = {}
        for ev in events:
            for slot, rid, kind, n, _ in ev.slots or ():
                if kind == "prefill":
                    total_prefill[rid] = total_prefill.get(rid, 0) + n
            self.preemptions += int(ev.counters.get("preemptions", 0))
        self.hit = {rid: prompt_len[rid] - n
                    for rid, n in total_prefill.items()}
        pos: Dict[int, int] = dict(self.hit)
        self.token_times: Dict[int, List[float]] = {}
        self.steps: List[Step] = []
        for ev in events:
            if not ev.slots:
                continue
            feeds = []
            for slot, rid, kind, n, emitted in ev.slots:
                p0 = pos.get(rid, 0)
                if n:
                    feeds.append(Feed(slot, rid, kind, n, emitted, p0))
                    pos[rid] = p0 + (n if kind == "prefill" else emitted)
                if emitted:
                    self.token_times.setdefault(rid, []).extend(
                        [ev.t_end] * emitted)
            self.steps.append(Step(ev.step, ev.t_start, ev.t_end,
                                   ev.occupancy, dict(ev.counters), feeds))

    def in_window(self, w0: float, w1: float) -> List[Step]:
        """Steps that ended inside (w0, w1]."""
        return [s for s in self.steps if w0 < s.t_end <= w1]

    def by_index(self, lo: int, hi: int) -> List[Step]:
        """Steps with index in [lo, hi)."""
        return [s for s in self.steps if lo <= s.index < hi]

    def gaps_in_window(self, w0: float, w1: float) -> np.ndarray:
        """Every gap between consecutive output tokens of a request with
        both tokens inside [w0, w1], seconds."""
        out = []
        for times in self.token_times.values():
            t = np.asarray(times)
            t = t[(t >= w0) & (t <= w1)]
            if t.size > 1:
                out.append(np.diff(t))
        return np.concatenate(out) if out else np.zeros((0,))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default), of a non-empty sample."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
