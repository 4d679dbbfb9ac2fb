"""Admission + batching policy for the continuous-batching engine.

FCFS over arrived requests, packing into whatever KV-arena capacity is
free. The scheduler owns the queue and the sequence registry; the arena
owns the storage; the engine step executor only ever sees (token,
position, active) vectors over the fixed slot axis — so admissions and
completions never change a traced shape.

Admission gates:
  * arrival time — a request joins the queue only once its ``arrival_s``
    has passed (request-stream replay);
  * capacity — the engine's ``admit_fn(seq)`` returns a slot only when
    the arena can host the sequence (a free slot for the contiguous
    arena; a free slot AND the *first chunk's* block reservation for the
    paged arena, since reservation then follows chunk progress). FCFS is
    strict: a refused head-of-queue blocks later arrivals rather than
    being skipped.
  * sequence budget — prompt_len + max_new_tokens must fit max_seq.

Admission is a *token-budget* decision rather than a whole-prompt
commitment — an admitted prompt streams through the unified step at up
to ``chunk`` tokens per iteration, and the per-step token budget
(``num_slots x chunk``, optionally capped lower by the engine's
``step_token_budget``) is divided decode-first, then
oldest-prefill-first; a prefilling slot that gets no budget this step
simply feeds zero tokens (counted in ``stats.deferred_feeds``) and
resumes next step.

Preemption (paged arena only): when decode crosses a block boundary and
the allocator is exhausted, the engine preempts the *youngest* admitted
sequence — its blocks are reclaimed and it re-enters the queue head, so
age order is preserved and the oldest sequence always finishes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.runtime.request import Request, SeqState, Sequence


@dataclasses.dataclass
class SchedulerStats:
    """Admission/occupancy counters for one serve run."""

    admitted: int = 0
    completed: int = 0
    preemptions: int = 0            # paged arena: preempt-to-queue events
    slot_reuses: int = 0            # admissions into a previously used slot
    queue_wait_sum: float = 0.0     # sum of per-admission queue waits (s)
    occupancy_sum: float = 0.0      # sum over steps of active-slot count
    max_occupancy: int = 0          # peak concurrent sequences
    steps: int = 0
    prefill_chunks: int = 0         # chunked mode: prompt chunks scheduled
    deferred_feeds: int = 0         # chunked mode: slots starved by budget
    spec_lanes_planned: int = 0     # speculative proposal lanes funded
    spec_lanes_trimmed: int = 0     # proposal lanes cut by budget pressure
    # Data-parallel serving: per-'data'-replica occupancy accumulators
    # (replica r owns slots [r*ns/dp, (r+1)*ns/dp); slot *assignment*
    # stays globally first-free — identity with single-device depends on
    # it — these only measure how evenly load lands across replicas).
    dp: int = 1
    replica_occupancy_sums: List[float] = dataclasses.field(
        default_factory=list)
    replica_max_occupancy: List[int] = dataclasses.field(
        default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        """Mean active-slot count per executed step."""
        return self.occupancy_sum / self.steps if self.steps else 0.0

    @property
    def mean_queue_wait(self) -> float:
        """Mean seconds an admission spent between arrival and its slot
        (re-admissions after preemption count from their original
        arrival — the request kept waiting)."""
        return self.queue_wait_sum / self.admitted if self.admitted \
            else 0.0

    @property
    def replica_mean_occupancy(self) -> List[float]:
        """Mean active-slot count per step, per 'data' replica."""
        if not self.steps:
            return [0.0] * self.dp
        return [s / self.steps for s in self.replica_occupancy_sums]


class Scheduler:
    """FCFS continuous-batching scheduler: request stream in, per-step
    admission into arena slots, preempt-to-queue on arena exhaustion.
    Arena-agnostic — slot/block policy lives behind the ``admit_fn`` /
    ``free_fn`` callables the engine supplies."""

    def __init__(self, num_slots: int, max_seq: int, dp: int = 1):
        if dp < 1 or num_slots % dp:
            raise ValueError(f"num_slots={num_slots} not divisible by "
                             f"dp={dp}")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.dp = dp
        self._rep_size = num_slots // dp
        self.pending: Deque[Sequence] = deque()     # submitted, not arrived
        self.queue: Deque[Sequence] = deque()       # arrived, waiting on slot
        self.active: Dict[int, Sequence] = {}       # slot -> sequence
        self.finished: List[Sequence] = []
        self._ever_used: set = set()
        self._admit_counter = 0
        # Telemetry StepTimeline (or None): admissions and preemptions
        # are reported through it when the engine enables telemetry.
        self.telemetry = None
        self.stats = SchedulerStats(
            dp=dp, replica_occupancy_sums=[0.0] * dp,
            replica_max_occupancy=[0] * dp)

    def replica_of(self, slot: int) -> int:
        """The 'data' replica hosting ``slot`` (contiguous block map)."""
        return slot // self._rep_size

    # -- submission ------------------------------------------------------
    def submit(self, req: Request) -> Sequence:
        """Wrap ``req`` in a Sequence and stage it on the pending queue
        (rejects budgets that can never fit the arena)."""
        budget = req.prompt_len + req.max_new_tokens
        if budget > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds arena max_seq {self.max_seq}")
        seq = Sequence(req)
        self.pending.append(seq)
        return seq

    # -- admission -------------------------------------------------------
    def poll_arrivals(self, now: float) -> None:
        """Move requests whose arrival time has passed into the run queue
        (submission order == arrival order for our generators)."""
        while self.pending and self.pending[0].req.arrival_s <= now:
            self.queue.append(self.pending.popleft())

    def admit(self, admit_fn: Callable[[Sequence], Optional[int]],
              now: float) -> List[Sequence]:
        """Admit queued sequences while ``admit_fn(seq)`` yields slots
        (None = arena refused: stop, strict FCFS). Returns the newly
        admitted sequences (state PREFILL, slot set)."""
        self.poll_arrivals(now)
        admitted: List[Sequence] = []
        while self.queue:
            slot = admit_fn(self.queue[0])
            if slot is None:
                break
            seq = self.queue.popleft()
            seq.admit(slot, now)
            seq.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.active[slot] = seq
            if slot in self._ever_used:
                self.stats.slot_reuses += 1
            self._ever_used.add(slot)
            self.stats.admitted += 1
            # Queue age: arrival (clamped for virtual replay, where
            # admission can precede the nominal arrival) to slot grant.
            wait = max(now - seq.req.arrival_s, 0.0)
            self.stats.queue_wait_sum += wait
            if self.telemetry is not None:
                self.telemetry.on_admit(seq.rid, now, wait)
            admitted.append(seq)
        return admitted

    # -- chunk scheduling (token-budget division, chunked mode) -----------
    def plan_feeds(self, chunk: int, budget: Optional[int] = None,
                   spec_extras: Optional[Dict[int, int]] = None
                   ) -> Dict[int, int]:
        """{slot: tokens to feed this step}. Decoding slots are funded
        first (1 token each — stalling an in-flight decode only delays its
        own completion); the remaining budget goes to prefilling slots
        oldest-first, up to ``chunk`` tokens each. ``budget`` defaults to
        ``num_slots * chunk`` (the traced step shape), so the cap only
        bites when the engine sets a tighter ``step_token_budget``. A
        starved prefill slot feeds 0 tokens and resumes next step.

        ``spec_extras``: {decode slot: desired speculative proposal
        lanes}. Speculation is funded *last*, oldest-first, from whatever
        budget survives decode + prefill — so under token-budget pressure
        the engine sheds proposal depth (down to plain 1-token decode)
        before it stalls a prompt chunk or an in-flight decode. Trimmed
        lanes are counted in ``stats.spec_lanes_trimmed``."""
        if budget is None:
            budget = self.num_slots * chunk
        feeds: Dict[int, int] = {}
        prefilling = []
        for slot, seq in self.active.items():
            if seq.state is SeqState.DECODE:
                feeds[slot] = 1
                budget -= 1
            else:
                prefilling.append(seq)
        for i, seq in enumerate(sorted(prefilling,
                                       key=lambda s: s.admit_seq)):
            n = min(seq.next_feed(chunk), max(budget, 0))
            if i == 0 and not feeds:
                n = max(n, 1)   # liveness: the oldest sequence always moves
            feeds[seq.slot] = n
            budget -= n
            if n:
                self.stats.prefill_chunks += 1
            else:
                self.stats.deferred_feeds += 1
        if spec_extras:
            by_age = sorted((s for s in spec_extras if s in feeds),
                            key=lambda s: self.active[s].admit_seq)
            for slot in by_age:
                want = min(spec_extras[slot], chunk - feeds[slot])
                grant = min(want, max(budget, 0))
                feeds[slot] += grant
                budget -= grant
                self.stats.spec_lanes_planned += grant
                self.stats.spec_lanes_trimmed += want - grant
        return feeds

    # -- step bookkeeping -------------------------------------------------
    def record_step(self) -> None:
        """Account one executed unified step (occupancy tallies, global
        and per-'data'-replica)."""
        self.stats.steps += 1
        self.stats.occupancy_sum += len(self.active)
        self.stats.max_occupancy = max(self.stats.max_occupancy,
                                       len(self.active))
        if self.dp > 1:
            counts = [0] * self.dp
            for slot in self.active:
                counts[self.replica_of(slot)] += 1
            for r, c in enumerate(counts):
                self.stats.replica_occupancy_sums[r] += c
                self.stats.replica_max_occupancy[r] = max(
                    self.stats.replica_max_occupancy[r], c)

    def retire(self, slot_free) -> List[Sequence]:
        """Collect DONE sequences, freeing their slots via ``slot_free``."""
        done = [s for s in self.active.values() if s.done]
        for seq in done:
            del self.active[seq.slot]
            slot_free(seq.slot)
            self.finished.append(seq)
            self.stats.completed += 1
        return done

    def preempt(self, seq: Sequence) -> int:
        """Evict an active sequence back to the *head* of the queue
        (recompute-preemption). Returns the freed slot id; the caller
        releases the arena resources. Head insertion keeps age priority:
        preempted (younger) sequences re-admit before later arrivals, and
        repeated preemption of youngest-first restores age order."""
        slot = seq.slot
        del self.active[slot]
        seq.preempt()
        self.queue.appendleft(seq)
        self.stats.preemptions += 1
        if self.telemetry is not None:
            self.telemetry.on_preempt(seq.rid)
        return slot

    def preempt_victim(self) -> Optional[Sequence]:
        """Youngest active sequence (latest admission) — the standard
        recompute-preemption victim: oldest work is never discarded, so
        the run always makes progress."""
        if not self.active:
            return None
        return max(self.active.values(), key=lambda s: s.admit_seq)

    # -- state queries ----------------------------------------------------
    @property
    def has_work(self) -> bool:
        """Whether any sequence is pending, queued or active."""
        return bool(self.pending or self.queue or self.active)

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the next not-yet-arrived request, if any."""
        return self.pending[0].req.arrival_s if self.pending else None
