"""Serving engine: continuous batching over the KV arena, ported from
``repro.runtime.engine`` (``ServingEngine``, and the lockstep ``Engine``
over it).

The layers are the JAX package's: ``runtime/request.py`` (sequence state
machine), ``runtime/scheduler.py`` (FCFS admission + token-budget chunk
planning), ``runtime/kvcache.py`` (paged arena with bf16 or int8 pages,
or the contiguous slot arena when ``block_size`` is None),
``runtime/transfers.py``
(host<->device byte ledger) and this file, the step executor: ONE
unified ``(slots, chunk)`` step over (params, token batch, base
positions, valid lengths, active mask, arena, block tables) with masked
per-slot sampling. Prompt tokens stream through the same step as decode,
up to ``chunk_size`` per slot per iteration; the step that consumes a
prompt's last token samples its first generated token from row
``lengths - 1``.

The step runs eagerly (no jit): its kernels launch on the card's current
stream, the arena's pages are written in place, and the sampled tokens
are read to the host after every step — the engine's one sync point.

Not ported yet, refused by the constructor with the ROADMAP item that
ports them: speculative decoding (A12), the prefix cache (A13), serving
meshes (A17) and the ssm/hybrid/encdec/vlm families (A16). Telemetry's
StepTimeline is A11.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import convert
from repro_torch.models.api import ModelAPI
from repro_torch.runtime import sampling
from repro_torch.runtime.kvcache import KV_QUANT_MODES, KVArena, PagedKVArena
from repro_torch.runtime.request import (Request, SamplingParams, SeqState,
                                         Sequence)
from repro_torch.runtime.scheduler import Scheduler, SchedulerStats
from repro_torch.runtime.transfers import TransferLedger, TransferReport


@dataclasses.dataclass
class GenStats:
    """Aggregate counters for one serve run (the JAX package's fields that
    the serve report prints)."""

    prefill_s: float = 0.0          # step wall time, prefill share
    decode_s: float = 0.0           # step wall time, decode share
    prefill_tokens: int = 0         # prompt tokens streamed
    decode_tokens: int = 0          # tokens emitted by decode steps
    cache_bytes: int = 0
    peak_resident_bytes: float = 0.0    # max arena bytes pinned by live seqs
    steps: int = 0                  # unified steps executed
    paged_kv_read_bytes: float = 0.0    # fused-kernel KV page reads
    step_s: List[float] = dataclasses.field(default_factory=list)
    transfers: Optional[TransferReport] = None

    @property
    def decode_tok_per_s(self) -> float:
        """Decode-phase throughput: decode-emitted tokens over the decode
        share of the step wall time."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


@dataclasses.dataclass
class ServeReport:
    """What a finished serve run reports."""

    stats: GenStats
    sequences: List[Sequence]       # finished, submission order
    sched: SchedulerStats
    wall_s: float = 0.0             # serve() wall time, admission included
    ledger: Optional[TransferLedger] = None

    def latency_percentiles(self, qs=(50, 90, 99)) -> Dict[int, float]:
        """Request-latency percentiles (seconds) over finished sequences."""
        lats = [s.latency_s for s in self.sequences if s.latency_s is not None]
        if not lats:
            return {q: 0.0 for q in qs}
        return {q: float(np.percentile(lats, q)) for q in qs}

    def step_ms_percentile(self, q: float = 50) -> float:
        """Percentile of the per-step wall time, milliseconds."""
        s = self.stats.step_s
        return float(np.percentile(s, q)) * 1e3 if s else 0.0

    @property
    def throughput_tok_s(self) -> float:
        """Generated tokens per second of serve() wall time."""
        return self.stats.decode_tokens / self.wall_s if self.wall_s else 0.0


# Families whose cache holds recurrent state rather than per-position KV.
RECURRENT_FAMILIES = ("ssm", "hybrid")


class ServingEngine:
    """Continuous-batching executor over the paged KV arena, or the
    contiguous slot arena when ``block_size`` is None."""

    def __init__(self, model: ModelAPI, params, *, quant: str = "none",
                 num_slots: int = 4, max_seq: int = 2048,
                 chunk_size: int = 8,
                 step_token_budget: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 paged_attn: str = "fused",
                 spec: str = "off", prefix_cache: bool = False,
                 kv_quant: str = "none", mesh=None,
                 offload_decisions: Optional[Dict[str, bool]] = None,
                 host_sampling: bool = False,
                 cache_dtype=torch.bfloat16, device="cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if paged_attn not in ("fused", "ref"):
            raise ValueError(f"unknown paged_attn {paged_attn!r}")
        if kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant mode {kv_quant!r} "
                             f"(choose from {KV_QUANT_MODES})")
        if kv_quant != "none":
            if block_size is None:
                raise ValueError(
                    "kv_quant requires the paged arena (set block_size): "
                    "quantize-on-insert and in-kernel dequant live on the "
                    "paged block-table path; the contiguous slot arena "
                    "has no quantized read path")
            if model.cfg.family in RECURRENT_FAMILIES:
                raise ValueError(
                    f"kv_quant is unsupported for the "
                    f"{model.cfg.family!r} family: recurrent state is a "
                    "running summary, not per-position KV pages — "
                    "requantizing it every step would compound rounding "
                    "error across the whole sequence")
            if model.cfg.family == "encdec":
                raise ValueError(
                    "kv_quant is unsupported for the 'encdec' family: "
                    "cross-attention KV is written by the one-time "
                    "encoder pass (write_prefill), which bypasses the "
                    "quantize-on-insert path")
        refusals = [
            (spec != "off", "speculative decoding is ROADMAP A12"),
            (prefix_cache, "the prefix cache and copy-on-write are "
                           "ROADMAP A13"),
            (mesh is not None, "serving meshes are ROADMAP A17"),
            (model.cfg.family not in ("dense", "moe"),
             f"the {model.cfg.family!r} family is ROADMAP A16"),
        ]
        for refused, why in refusals:
            if refused:
                raise NotImplementedError(f"not ported to repro_torch: {why}")
        self.model = model
        self.params = params
        self.quant = quant
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.chunk_size = max(1, min(chunk_size, max_seq))
        self.step_token_budget = step_token_budget
        self.top_k, self.top_p = top_k, top_p
        self.paged = block_size is not None
        self.paged_attn = paged_attn
        self.kv_quant = kv_quant
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self._block_size, self._num_blocks = block_size, num_blocks
        self._ledger_kw = dict(decisions=offload_decisions,
                               host_sampling=host_sampling,
                               kv_quant=kv_quant)
        self._fresh_arena_sched()

    # ------------------------------------------------------------------
    def _fresh_arena_sched(self) -> None:
        if self.paged:
            self.arena = PagedKVArena(self.model, self.num_slots,
                                      self.max_seq,
                                      block_size=self._block_size,
                                      num_blocks=self._num_blocks,
                                      dtype=self.cache_dtype,
                                      kv_quant=self.kv_quant,
                                      device=self.device)
        else:
            self.arena = KVArena(self.model, self.num_slots, self.max_seq,
                                 dtype=self.cache_dtype, device=self.device)
        self.sched = Scheduler(self.num_slots, self.max_seq)

    def reset(self) -> None:
        """Fresh arena and scheduler: serve() runs are independent."""
        self._fresh_arena_sched()

    # ------------------------------------------------------------------
    def _try_admit(self, seq: Sequence) -> Optional[int]:
        """Admission gate. Contiguous arena: any free slot. Paged arena: a
        free slot AND the first chunk's block reservation, all-or-nothing
        (reservation then follows chunk progress)."""
        if not self.paged:
            return self.arena.alloc()
        first = min(seq.req.prompt_len, self.chunk_size)
        return self.arena.alloc_slot(self.arena.blocks_needed(first))

    def _admit_chunked(self, seq: Sequence, ledger: TransferLedger) -> None:
        """Chunked admission: no prefill pass. Reset the slot's constant
        state leaves; on the paged arena the admission's blocks are
        charged as cache growth (the contiguous arena charges growth per
        fed token instead)."""
        self.arena.reset_slot(seq.slot)
        if self.paged:
            growth_blocks = len(self.arena.slot_blocks(seq.slot))
            ledger.charge_cache_growth(
                "prefill", growth_blocks * self.arena.block_bytes())

    def _preempt(self, seq: Sequence) -> None:
        """Recompute-preemption: reclaim the victim's slot and blocks and
        push it back to the queue head."""
        slot = self.sched.preempt(seq)
        self.arena.free(slot)

    def _reserve_blocks(self, ledger: TransferLedger) -> None:
        """Grow each active sequence's block table to cover its next feed,
        oldest-first; on allocator exhaustion preempt the youngest active
        sequence and retry (age order guarantees the oldest sequence can
        always run alone, so the stream never deadlocks)."""
        by_age = sorted(self.sched.active.values(),
                        key=lambda s: s.admit_seq)
        for seq in by_age:
            slot = seq.slot
            if self.sched.active.get(slot) is not seq:
                continue                        # preempted by an earlier turn
            phase = "prefill" if seq.state is SeqState.PREFILL else "decode"
            while True:
                bound = seq.next_feed(self.chunk_size)
                fresh = self.arena.ensure(slot, seq.position + bound)
                if fresh is None:
                    victim = self.sched.preempt_victim()
                    self._preempt(victim)
                    if victim is seq:
                        break                   # evicted ourselves: skip step
                    continue
                if fresh:
                    ledger.charge_cache_growth(
                        phase, fresh * self.arena.block_bytes())
                break

    def _sampling_vectors(self, seqs: Dict[int, Sequence]):
        """Per-slot temperature/top_k/top_p arrays (engine defaults fill
        request-level unset values)."""
        ns = self.num_slots
        temps = np.zeros((ns,), np.float32)
        top_ks = np.zeros((ns,), np.int32)
        top_ps = np.ones((ns,), np.float32)
        for slot, seq in seqs.items():
            sp = seq.req.sampling
            temps[slot] = sp.temperature
            top_ks[slot] = sp.top_k if sp.top_k else self.top_k
            top_ps[slot] = sp.top_p if sp.top_p < 1.0 else self.top_p
        return temps, top_ks, top_ps

    def _step_once(self, gen: torch.Generator, stats: GenStats,
                   ledger: TransferLedger, t0: float) -> None:
        """One unified (slots, chunk) step: prompt chunks and decode
        feedback tokens ride the same shape. Token timestamps are read
        after the step's host sync."""
        ns, C = self.num_slots, self.chunk_size
        feeds = self.sched.plan_feeds(C, self.step_token_budget)
        tokens = np.zeros((ns, C), np.int32)
        pos0 = np.zeros((ns,), np.int32)
        lens = np.zeros((ns,), np.int32)
        active = np.zeros((ns,), bool)
        for slot, seq in self.sched.active.items():
            n = feeds[slot]
            if seq.state is SeqState.PREFILL:
                tokens[slot, :n] = seq.req.tokens[seq.fed:seq.fed + n]
            else:
                tokens[slot, 0] = seq.next_token
                n = 1
                feeds[slot] = n
            pos0[slot] = seq.position
            lens[slot] = n
            active[slot] = True
        temps, top_ks, top_ps = self._sampling_vectors(self.sched.active)

        t_step = time.perf_counter()
        dev = self.device
        put = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
        dev_tables = None
        if self.paged:
            dev_tables, uploaded = self.arena.device_tables()
            if uploaded:        # dirty tables only: admission/growth/preempt
                ledger.charge("decode", "tables", "h2d", uploaded)
        lens_t = put(lens)
        logits, _ = self.model.decode_step(
            self.params, put(tokens), put(pos0), self.arena.buffers,
            quant=self.quant, block_tables=dev_tables, lengths=lens_t,
            paged_impl=self.paged_attn)
        idx = torch.clamp(lens_t.to(torch.long) - 1, min=0)
        last = logits[torch.arange(ns, device=dev), idx]           # (B, V)
        nxt = sampling.sample_slots(
            last, gen, put(temps), put(active), top_k=put(top_ks),
            top_p=put(top_ps), stochastic=bool(np.any(temps > 0)))
        nxt_host = nxt.cpu().numpy()          # blocks until step completes
        t_end = time.perf_counter()
        now = t_end - t0

        pre_toks = sum(n for s, n in feeds.items()
                       if self.sched.active[s].state is SeqState.PREFILL)
        dec_toks = sum(n for s, n in feeds.items()
                       if self.sched.active[s].state is SeqState.DECODE)
        frac = pre_toks / max(pre_toks + dec_toks, 1)
        dt = t_end - t_step
        stats.step_s.append(dt)
        stats.prefill_s += dt * frac
        stats.decode_s += dt * (1.0 - frac)
        ledger.charge_step_weights(prefill_frac=frac)

        stats.peak_resident_bytes = max(stats.peak_resident_bytes,
                                        self.arena.resident_bytes())
        if self.paged:
            stats.paged_kv_read_bytes += self._paged_reads(pos0, lens) \
                * self.arena.block_bytes()
        # The contiguous arena grows by token, the paged one by block (at
        # reservation).
        tok_bytes = 0.0 if self.paged else self.arena.token_bytes()
        for slot, seq in list(self.sched.active.items()):
            n = feeds[slot]
            if seq.state is SeqState.PREFILL:
                if n == 0:
                    continue                  # budget-starved this step
                stats.prefill_tokens += n
                ledger.charge_chunk("prefill", n, seq.fed + n)
                if tok_bytes:
                    ledger.charge_cache_growth("prefill", n * tok_bytes)
                if seq.feed_chunk(n):
                    seq.start_decode()        # this chunk sampled token 0
                    ledger.charge_sampled()
                    seq.record_token(int(nxt_host[slot]), now)
                    stats.decode_tokens += 1
            else:
                ledger.charge_chunk("decode", 1, int(pos0[slot]) + 1)
                r = 0
                if not seq.done:              # generation budget left
                    seq.record_token(int(nxt_host[slot]), now)
                    r = 1
                if tok_bytes:
                    ledger.charge_cache_growth("decode", r * tok_bytes)
                ledger.charge_sampled(r, logit_rows=1)
                stats.decode_tokens += r
        stats.steps += 1
        self.sched.record_step()
        self.sched.retire(self.arena.free)

    def _paged_reads(self, pos0: np.ndarray, lens: np.ndarray) -> int:
        """Pages the step's attention reads, for the KV read counter."""
        ns = self.num_slots
        bsz, mb = self.arena.block_size, self.arena.max_blocks
        if self.paged_attn == "fused":
            # The kernel's page reads: a slot row walks blocks
            # 0..(pos0 + max(lengths,1) - 1)//bs, counted as distinct
            # consecutive pages as the JAX ledger does (an idle slot's
            # all-null row costs one null-page read).
            tb = self.arena.tables
            reads = 0
            for s in range(ns):
                depth = int(pos0[s]) + max(int(lens[s]), 1) - 1
                walk = tb[s, :min(depth // bsz, mb - 1) + 1]
                reads += 1 + int(np.sum(walk[1:] != walk[:-1]))
        else:
            reads = ns * mb             # dense gather of every table row
        return reads

    # ------------------------------------------------------------------
    def serve(self, requests: List[Request], *, seed: int = 0,
              realtime: bool = True) -> ServeReport:
        """Run a request stream to completion. ``realtime``: honor
        ``arrival_s`` offsets against the wall clock (sleep while idle);
        False replays arrivals against the virtual step clock only.
        Each run gets a fresh scheduler; the arena's page storage is
        reused (its tables are empty between runs)."""
        if self.sched.stats.steps or self.sched.finished:
            self.sched = Scheduler(self.num_slots, self.max_seq)
        for r in requests if self.paged else ():
            # Last cache write lands at position prompt+gen-2 (the final
            # sampled token is returned, never inserted), so peak demand
            # is prompt+gen-1 covered positions.
            need = self.arena.blocks_needed(r.prompt_len
                                            + r.max_new_tokens - 1)
            if need > self.arena.num_blocks:
                raise ValueError(
                    f"request {r.rid}: needs {need} blocks at full "
                    f"length, arena has {self.arena.num_blocks} — "
                    f"could never finish even running alone")
        for r in requests:
            self.sched.submit(r)
        stats = GenStats()
        ledger = TransferLedger(self.model.cfg, self.quant,
                                **self._ledger_kw)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        t0 = time.perf_counter()

        while self.sched.has_work:
            now = time.perf_counter() - t0
            if self.paged:
                # Incumbents reserve their next-feed blocks BEFORE new
                # admissions take them (may preempt-to-queue).
                self._reserve_blocks(ledger)
            for seq in self.sched.admit(self._try_admit, now):
                self._admit_chunked(seq, ledger)
            if not self.sched.active:
                if self.sched.queue:
                    continue    # preempted/starved: blocks freed, re-admit
                nxt = self.sched.next_arrival()
                if nxt is None:
                    break
                if realtime:
                    time.sleep(min(max(nxt - now, 0.0), 0.05))
                else:
                    self.sched.poll_arrivals(float("inf"))
                continue
            self._step_once(gen, stats, ledger, t0)

        wall = time.perf_counter() - t0
        stats.cache_bytes = self.arena.nbytes()
        stats.transfers = TransferReport.from_ledger(ledger)
        order = {r.rid: i for i, r in enumerate(requests)}
        seqs = sorted(self.sched.finished, key=lambda s: order[s.rid])
        return ServeReport(stats=stats, sequences=seqs,
                           sched=self.sched.stats, wall_s=wall,
                           ledger=ledger)


class Engine:
    """Fixed-batch (lockstep) wrapper over ``ServingEngine``.

    ``generate(tokens, n)`` submits one request per batch row (identical
    lengths, simultaneous arrival) to a contiguous-arena engine and
    reassembles a dense (B, n) output — the legacy lockstep interface,
    kept for the paper's fixed [in:out] workload grid. Engines are kept
    per batch size; each ``generate`` gets a fresh arena and drops it
    afterwards."""

    def __init__(self, model: ModelAPI, params, *, quant: str = "none",
                 max_seq: int = 2048, chunk_size: int = 8, device="cuda"):
        self.model = model
        self.params = params
        self.quant = quant
        self.max_seq = max_seq
        self.chunk_size = chunk_size
        self.device = torch.device(device)
        self._engines: Dict[int, ServingEngine] = {}    # batch -> engine

    @classmethod
    def from_dense(cls, model: ModelAPI, dense_params, quant: str,
                   **kw) -> "Engine":
        """llama.cpp-style model quantization stage + engine construction."""
        qparams = convert.quantize_params(dense_params, quant) \
            if quant != "none" else dense_params
        return cls(model, qparams, quant=quant, **kw)

    def _engine_for(self, batch: int) -> ServingEngine:
        if batch not in self._engines:
            self._engines[batch] = ServingEngine(
                self.model, self.params, quant=self.quant,
                num_slots=batch, max_seq=self.max_seq,
                chunk_size=self.chunk_size, device=self.device)
        else:
            self._engines[batch].reset()
        return self._engines[batch]

    def generate(self, tokens, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        """tokens: (B, S_prompt) int (numpy or tensor). Returns
        (out_tokens (B, T) int32 numpy, stats)."""
        toks = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                          else tokens)
        b, s_prompt = toks.shape
        if s_prompt + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt {s_prompt} + {max_new_tokens} new "
                             f"tokens exceed the arena's {self.max_seq}")
        eng = self._engine_for(b)
        samp = SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed)
        reqs = [Request(rid=i, tokens=toks[i], max_new_tokens=max_new_tokens,
                        sampling=samp) for i in range(b)]
        try:
            report = eng.serve(reqs, seed=seed, realtime=False)
        finally:
            eng.arena = eng.sched = None    # a full-size arena is large
        out = np.stack([np.asarray(q.generated, np.int32)
                        for q in report.sequences])
        return out, report.stats
