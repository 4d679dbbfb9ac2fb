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

Prefix sharing (``prefix_cache=True``, paged arena): admission maps the
longest cached chain of full prompt blocks onto existing pages and
fast-forwards the sequence past them; before every step a copy-on-write
barrier splits any shared block the step would write. Telemetry
(``telemetry=True``) records a ``StepTimeline`` per run, host-side only,
with the serve loop's named spans (``engine.step`` and its phases, from
block reservation to the commit of the sampled tokens; ``_Spans``) and
each step's phase seconds (``TIMING_COUNTERS``).

Speculative decoding (``spec={"ngram","draft"}``): the unified step
doubles as the *verifier*. A decoding slot feeds its committed token plus
up to k proposed tokens (prompt-lookup n-grams, or a small draft model
with its own arena and ledger account — ``runtime/speculative.py``);
``sampling.verify_slots`` reads every fed position's logits for the
per-slot accept lengths and the one token emitted past the accepted
prefix, and the rejected suffix is rolled back in place (KV positions
zeroed, paged table tails trimmed). Proposal lanes are funded from the
step's leftover token budget and shrink with a per-slot accept-rate EMA.

The recurrent families (mamba2, jamba) serve through the same step:
their SSM state lives per slot beside the pages (``runtime/kvcache.py``)
and admission zeroes it (``reset_slot``). They refuse speculation, the
prefix cache and int8 pages, as the JAX engine does.

The conditioned families serve through it too. An encdec (whisper)
admission runs the encoder once (``model.encode_cross`` on the request's
``extras["frames"]``) and writes the cross K/V into the slot's state
leaves; the decoder prompt then streams through the step. A vlm
(qwen2-vl) prompt's first ``vision_tokens`` positions take the
request's ``extras["vision_embeds"]`` rows in place of their token
embeddings (``_vision_override``, per prompt chunk). Both refuse the
prefix cache, and encdec refuses int8 pages and the draft proposer, as
the JAX engine does.

Serving meshes (``mesh=``, a ``launch/mesh.py`` ``ServingMesh``; one
process per mesh device, every rank running this engine): the weights
are cut over 'model' (``core/convert.shard_params``) and the slots over
'data' in contiguous blocks — replica d steps slots [d ns/dp, (d+1)
ns/dp) through the model, inside ``sharding.activation_mesh``. Every
rank runs the same scheduler over all slots, so the sampled tokens (and
accepted lanes) are all-gathered over 'data' before the read-back, and
the rows a step wrote into the page pool are all-gathered and written
into every replica's pool (``PagedKVArena.sync_writes``). The sampler
draws its noise for the whole step and keeps the replica's rows, so a
stochastic stream moves the generator as one device does. The draft
model shards over the same mesh's 'model' axis and drafts every slot on
every replica.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import convert
from repro_torch.kernels import _build, paged_attention
from repro_torch.models.api import ModelAPI
from repro_torch.parallel import sharding
from repro_torch.runtime import sampling, speculative
from repro_torch.runtime.kvcache import KV_QUANT_MODES, KVArena, PagedKVArena
from repro_torch.runtime.request import (Request, SamplingParams, SeqState,
                                         Sequence)
from repro_torch.runtime.scheduler import Scheduler, SchedulerStats
from repro_torch.runtime.telemetry import TIMING_COUNTERS, StepTimeline
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
    resident_bytes_sum: float = 0.0     # per-step resident-bytes accumulator
    live_tokens_sum: int = 0            # per-step live-cache-token accumulator
    steps: int = 0                  # unified steps executed
    paged_kv_read_bytes: float = 0.0    # fused-kernel KV page reads
    paged_kv_read_bytes_per_device: float = 0.0  # busiest replica's share
    prefix_hits: int = 0            # admissions that mapped a cached prefix
    prefix_hit_tokens: int = 0      # prompt positions served from shared pages
    cow_splits: int = 0             # copy-on-write block splits this run
    spec_proposed: int = 0          # proposal lanes fed to the verifier
    spec_accepted: int = 0          # proposal lanes accepted
    spec_rolled_back: int = 0       # rejected KV positions rolled back
    step_s: List[float] = dataclasses.field(default_factory=list)
    transfers: Optional[TransferReport] = None
    draft_transfers: Optional[TransferReport] = None  # spec="draft" account

    @property
    def steps_per_token(self) -> float:
        """Unified steps per generated token — the transfer-amortization
        ratio: the linear weights stream once per step, so accepted
        speculative tokens push it below plain decode's 1 per token."""
        return self.steps / self.decode_tokens if self.decode_tokens else 0.0

    @property
    def spec_accept_rate(self) -> float:
        """Accepted fraction of proposed speculative tokens."""
        return self.spec_accepted / self.spec_proposed \
            if self.spec_proposed else 0.0

    @property
    def decode_tok_per_s(self) -> float:
        """Decode-phase throughput: decode-emitted tokens over the decode
        share of the step wall time."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def resident_bytes_per_token(self) -> float:
        """Mean arena bytes *reserved* per live cache token over the run —
        the slot arena pins max_seq per sequence, the paged arena pins
        ceil(len/block)*block."""
        return self.resident_bytes_sum / self.live_tokens_sum \
            if self.live_tokens_sum else 0.0


@dataclasses.dataclass
class ServeReport:
    """What a finished serve run reports."""

    stats: GenStats
    sequences: List[Sequence]       # finished, submission order
    sched: SchedulerStats
    wall_s: float = 0.0             # serve() wall time, admission included
    ledger: Optional[TransferLedger] = None
    # Kernel libraries built or loaded during the engine's steps (the
    # port's analogue of the JAX step's jit compilations; 0 once warm).
    step_compiles: int = 0
    # Telemetry StepTimeline (engine telemetry=True).
    timeline: Optional[StepTimeline] = None
    # This rank's collectives over the run under a serving mesh
    # (``ServingMesh.stats``: count, bytes sent, staged through host).
    collectives: Optional[Dict] = None

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


def mla_plan_note(model: ModelAPI, *, dp: int, tp: int, device, paged: bool,
                  paged_attn: str, pages_dtype) -> Optional[str]:
    """Why the paged MLA kernel on a rank of a ``dp`` x ``tp`` serving
    mesh may split a row's page walk otherwise than one device does, so
    that the mesh's tokens are one device's only up to near-ties; None
    where its rows are one device's bit for bit. The tensor-core MLA
    kernel (B9, bf16 or int8 pages) plans from the whole step
    (``paged_attention.MlaPlan``), as every other kernel plans from the
    unsharded shape, so only the CUDA-core MLA kernel (f32 pages, on no
    serving path) gets a note. Only the card's fused paged path runs
    them."""
    if (dp, tp) == (1, 1) or model.cfg.mla is None or not paged \
            or paged_attn != "fused" or torch.device(device).type != "cuda":
        return None
    if pages_dtype == torch.float32:
        return ("the CUDA-core MLA kernel (f32 pages) picks its split from "
                "its shard's rows")
    return None


_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


def _range(name: str):
    """An open ``_RecordFunctionFast`` range (the profiler is on)."""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class _Spans:
    """The serve loop's named spans, with telemetry on: ``engine.step``
    around an iteration that steps, its phases one after another inside
    it (``phase`` ends the open phase and starts the next, so they tile
    the step), and ``engine.reserve``/``engine.admit``/``engine.wait``
    while no slot is active. A closed span lands on the timeline
    (``StepTimeline.record_span``; ns from the serve's start,
    ``time.perf_counter_ns``), and a phase inside a step adds its
    seconds to its counter of ``TIMING_COUNTERS``.

    While ``torch.profiler`` records, each span is also a
    ``_RecordFunctionFast`` range: a plain host op on the profiler's
    clock. Never ``record_function``: the profiler copies its ranges onto
    the device's track, where a trace would count them as device work.
    No name starts with ``cu``, which a trace reads as a CUDA call."""

    def __init__(self, tl: StepTimeline, t0_ns: int):
        self.t0_ns = t0_ns
        self._events, self._record = tl.events, tl.record_span
        self.totals = dict.fromkeys(TIMING_COUNTERS, 0.0)
        self._step = None       # (step index, range, start ns)
        self._phase = None      # (name, counter, range, start ns)

    def open_step(self) -> None:
        """Open ``engine.step`` (no-op while one is open)."""
        if self._step is None:
            self._step = (len(self._events),
                          _range("engine.step") if _profiling() else None,
                          _now())

    def close_step(self) -> None:
        """Close the open phase and ``engine.step`` (no-op without one)."""
        if self._step is None:
            return
        self.close()
        t = _now()
        step, rng, t0 = self._step
        self._step = None
        if rng is not None:
            rng.__exit__(None, None, None)
        self._record("engine.step", step, None, t0 - self.t0_ns,
                     t - self.t0_ns)

    def phase(self, name: str, counter: Optional[str] = None) -> None:
        """End the open phase and start ``name`` (timed into ``counter``
        inside a step)."""
        t = _now()
        if self._phase is not None:
            self._end(t, ())
        self._phase = (name, counter,
                       _range(name) if _profiling() else None, t)

    def close(self, admitted=()) -> None:
        """End the open phase; ``admitted``: the sequences it admitted."""
        if self._phase is not None:
            self._end(_now(), tuple([s.rid for s in admitted])
                      if admitted else ())

    def _end(self, t: int, rids) -> None:
        name, counter, rng, t0 = self._phase
        self._phase = None
        if rng is not None:
            rng.__exit__(None, None, None)
        if self._step is None:
            self._record(name, len(self._events), None, t0 - self.t0_ns,
                         t - self.t0_ns, rids)
            return
        if counter is not None:
            self.totals[counter] += (t - t0) / 1e9
        self._record(name, self._step[0], "engine.step", t0 - self.t0_ns,
                     t - self.t0_ns, rids)


class _NoSpans:
    """``_Spans``' calls with telemetry off: nothing is read or kept."""

    def open_step(self) -> None:
        pass

    close_step = open_step

    def phase(self, name: str, counter: Optional[str] = None) -> None:
        pass

    def close(self, admitted=()) -> None:
        pass


_NO_SPANS = _NoSpans()


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
                 spec: str = "off", spec_k: int = 4,
                 spec_draft_model: Optional[ModelAPI] = None,
                 spec_draft_params=None, prefix_cache: bool = False,
                 kv_quant: str = "none", mesh=None,
                 offload_decisions: Optional[Dict[str, bool]] = None,
                 host_sampling: bool = False, telemetry: bool = False,
                 cache_dtype=torch.bfloat16, device="cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if paged_attn not in ("fused", "ref"):
            raise ValueError(f"unknown paged_attn {paged_attn!r}")
        if spec not in speculative.SPEC_MODES:
            raise ValueError(f"unknown spec mode {spec!r} (choose from "
                             f"{speculative.SPEC_MODES})")
        if spec != "off":
            if model.cfg.family in speculative.RECURRENT_FAMILIES:
                raise ValueError(
                    f"speculative decoding is unsupported for the "
                    f"{model.cfg.family!r} family: rejected tokens have "
                    "advanced the recurrent state, which cannot be rolled "
                    "back without recomputation")
            if chunk_size < 2:
                raise ValueError("speculative decoding needs chunk_size "
                                 ">= 2 (one committed-token lane plus at "
                                 "least one proposal lane)")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if spec == "draft":
            if spec_draft_model is None or spec_draft_params is None:
                raise ValueError("spec='draft' requires spec_draft_model "
                                 "and spec_draft_params")
            if spec_draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {spec_draft_model.cfg.vocab_size} != "
                    f"target vocab {model.cfg.vocab_size}: proposal ids "
                    "would not be target token ids")
            if model.cfg.family == "encdec":
                raise ValueError("spec='draft' supports decoder-only "
                                 "families (the draft has no encoder "
                                 "frames to condition on)")
        if prefix_cache:
            if block_size is None:
                raise ValueError("prefix_cache requires the paged arena "
                                 "(set block_size)")
            if model.cfg.family in speculative.RECURRENT_FAMILIES:
                raise ValueError(
                    f"prefix_cache is unsupported for the "
                    f"{model.cfg.family!r} family: recurrent state is not "
                    "addressable by token-block chains")
            if model.cfg.family in ("encdec", "vlm"):
                raise ValueError(
                    f"prefix_cache is unsupported for the "
                    f"{model.cfg.family!r} family: prompt KV depends on "
                    "per-request conditioning (encoder frames / vision "
                    "embeddings), so equal token chains do not imply "
                    "equal pages")
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
            if model.cfg.family in speculative.RECURRENT_FAMILIES:
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
        self.mesh = mesh
        self.dp, self.tp = sharding.serving_degrees(mesh)
        if mesh is not None:
            sharding.validate_serving_mesh(
                mesh, num_heads=model.cfg.num_heads,
                num_kv_heads=model.cfg.num_kv_heads,
                vocab_size=model.cfg.vocab_size, num_slots=num_slots)
            if spec == "draft":
                # The draft model shards over the *same* mesh, so it must
                # satisfy the same divisibility.
                sharding.validate_serving_mesh(
                    mesh, num_heads=spec_draft_model.cfg.num_heads,
                    num_kv_heads=spec_draft_model.cfg.num_kv_heads,
                    vocab_size=spec_draft_model.cfg.vocab_size,
                    num_slots=num_slots)
                spec_draft_params = convert.shard_params(spec_draft_params,
                                                         mesh)
            params = convert.shard_params(params, mesh)
        # This rank's 'data' replica: its slot block [lo, hi).
        rep = num_slots // self.dp
        lo = mesh.coords["data"] * rep if mesh is not None else 0
        self._rows = (lo, lo + rep)
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
        self.spec = spec
        self.spec_k = min(spec_k, self.chunk_size - 1) if spec != "off" \
            else 0
        pages_dtype = torch.int8 if kv_quant == "int8" else cache_dtype
        self.plan_note = mla_plan_note(
            model, dp=self.dp, tp=self.tp, device=self.device,
            paged=self.paged, paged_attn=paged_attn,
            pages_dtype=pages_dtype)
        if spec == "draft" and self.plan_note is None:
            self.plan_note = mla_plan_note(
                spec_draft_model, dp=1, tp=self.tp, device=self.device,
                paged=self.paged, paged_attn=paged_attn,
                pages_dtype=pages_dtype)
        self._spec_ctrl = speculative.SpecController(k_max=self.spec_k) \
            if spec != "off" else None
        self._proposer = speculative.make_proposer(
            spec, draft_model=spec_draft_model,
            draft_params=spec_draft_params, num_slots=num_slots,
            max_seq=max_seq, chunk=self.chunk_size, quant=quant,
            cache_dtype=cache_dtype, device=self.device, mesh=mesh) \
            if spec != "off" else None
        self._block_size, self._num_blocks = block_size, num_blocks
        self.prefix_cache = prefix_cache
        self._ledger_kw = dict(decisions=offload_decisions,
                               host_sampling=host_sampling,
                               kv_quant=kv_quant, dp=self.dp, tp=self.tp)
        # Telemetry: when enabled, serve() builds a StepTimeline per run
        # (host-side only: no device sync, no kernel launch).
        self.telemetry = telemetry
        self._timeline: Optional[StepTimeline] = None
        self._spans = _NO_SPANS
        self._vlm = model.cfg.family == "vlm"
        self._encode_cross = model.encode_cross
        self._run_cow0 = 0
        self._step_compiles = 0
        self._fresh_arena_sched()

    # ------------------------------------------------------------------
    def _fresh_arena_sched(self) -> None:
        if self.paged:
            self.arena = PagedKVArena(self.model, self.num_slots,
                                      self.max_seq,
                                      block_size=self._block_size,
                                      num_blocks=self._num_blocks,
                                      dtype=self.cache_dtype,
                                      prefix_cache=self.prefix_cache,
                                      kv_quant=self.kv_quant,
                                      device=self.device, mesh=self.mesh)
        else:
            self.arena = KVArena(self.model, self.num_slots, self.max_seq,
                                 dtype=self.cache_dtype, device=self.device,
                                 mesh=self.mesh)
        self.sched = Scheduler(self.num_slots, self.max_seq, dp=self.dp)
        # rid -> (hit_tokens, resident_growth_blocks) recorded by the
        # admission gate, consumed by _admit_chunked after seq.admit().
        self._pending_prefix: Dict[int, tuple] = {}

    def reset(self) -> None:
        """Fresh arena (dropping the prefix cache) and scheduler."""
        self._fresh_arena_sched()

    # ------------------------------------------------------------------
    def _try_admit(self, seq: Sequence) -> Optional[int]:
        """Admission gate. Contiguous arena: any free slot. Paged arena: a
        free slot AND the first chunk's block reservation, all-or-nothing
        (reservation then follows chunk progress)."""
        if not self.paged:
            return self.arena.alloc()
        if self.prefix_cache:
            got = self.arena.alloc_slot_prefix(seq.req.tokens,
                                               self.chunk_size)
            if got is None:
                return None
            slot, hit, growth = got
            self._pending_prefix[seq.rid] = (hit, growth)
            return slot
        first = min(seq.req.prompt_len, self.chunk_size)
        return self.arena.alloc_slot(self.arena.blocks_needed(first))

    def _admit_chunked(self, seq: Sequence, stats: GenStats,
                       ledger: TransferLedger) -> None:
        """Chunked admission: no prefill pass. Reset the slot's constant
        state leaves; on the paged arena the admission's blocks are
        charged as cache growth (the contiguous arena charges growth per
        fed token instead). A prefix-cache hit recorded by the admission
        gate fast-forwards the sequence past the shared prompt positions
        — their KV already sits in mapped pages, so they are neither
        streamed nor recomputed, and only newly resident blocks are
        charged as cache growth."""
        self.arena.reset_slot(seq.slot)
        self._reset_spec(seq.slot)
        hit, growth_blocks = self._pending_prefix.pop(seq.rid, (0, None))
        if self.paged:
            if growth_blocks is None:
                growth_blocks = len(self.arena.slot_blocks(seq.slot))
            ledger.charge_cache_growth(
                "prefill", growth_blocks * self.arena.block_bytes())
        if hit:
            seq.apply_prefix_hit(hit)
            stats.prefix_hits += 1
            stats.prefix_hit_tokens += hit
            ledger.record_prefix_hit(hit)
        if self._encode_cross is not None and seq.req.extras \
                and "frames" in seq.req.extras:
            frames = torch.as_tensor(seq.req.extras["frames"])
            # The one-time encoder pass, timed to its end as the JAX
            # engine's (one sync per admission, none added to the step).
            # Under a mesh only the replica owning the slot runs it (the
            # cross K/V is a per-slot state leaf); every rank charges it.
            if self._rows[0] <= seq.slot < self._rows[1]:
                t0 = time.perf_counter()
                with sharding.activation_mesh(self.mesh):
                    cache = self._encode_cross(
                        self.params, frames.to(self.device),
                        quant=self.quant)
                self.arena.write_prefill(cache, seq.slot)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                stats.prefill_s += time.perf_counter() - t0
            ledger.charge("prefill", "acts", "h2d",
                          frames.numel() * frames.element_size())
            # The cross K/V the encoder pass writes: bf16 (L, 1, frames,
            # Hkv, D) per leaf, its bytes from the arena leaves' widths.
            ledger.charge_cache_growth("prefill", sum(
                t.numel() // (self.num_slots * t.shape[2]) * frames.shape[-2]
                * torch.bfloat16.itemsize
                for t in self.arena.buffers["dec_layers"]["cross"].values()))

    def _preempt(self, seq: Sequence) -> None:
        """Recompute-preemption: reclaim the victim's slot and blocks (a
        decref per block — pages shared with siblings stay resident) and
        push it back to the queue head. Speculative per-slot state is
        reset here too, not only at slot reuse: a preempted-then-
        readmitted sequence restarts from clean speculation state,
        whichever slot it lands in."""
        slot = self.sched.preempt(seq)
        self._reset_spec(slot)
        self.arena.free(slot)

    def _reset_spec(self, slot: int) -> None:
        """Drop ``slot``'s speculation state: the accept-rate EMA and, for
        the draft proposer, its mirrored draft-arena slot."""
        if self._proposer is None:
            return
        reset = getattr(self._proposer, "reset_slot", None)
        if reset is not None:
            reset(slot)
        self._spec_ctrl.reset(slot)

    def _reserve_blocks(self, ledger: TransferLedger) -> None:
        """Grow each active sequence's block table to cover its next feed,
        oldest-first; on allocator exhaustion preempt the youngest active
        sequence and retry (age order guarantees the oldest sequence can
        always run alone, so the stream never deadlocks). With the prefix
        cache, the copy-on-write barrier follows: every shared block the
        coming write range maps to is split before the step launches, so
        the step's page insert never writes a page a sibling reads."""
        by_age = sorted(self.sched.active.values(),
                        key=lambda s: s.admit_seq)
        for seq in by_age:
            slot = seq.slot
            if self.sched.active.get(slot) is not seq:
                continue                        # preempted by an earlier turn
            phase = "prefill" if seq.state is SeqState.PREFILL else "decode"
            while True:
                bound = self._next_feed_bound(seq)
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
                if not self.prefix_cache:
                    break
                # A fresh copy is arena growth like any other block.
                cow = self.arena.prepare_write(slot, seq.position, bound)
                if cow is None:
                    victim = self.sched.preempt_victim()
                    self._preempt(victim)
                    if victim is seq:
                        break                   # evicted ourselves: skip step
                    continue
                if cow:
                    ledger.charge_cache_growth(
                        phase, cow * self.arena.block_bytes())
                break

    def _next_feed_bound(self, seq: Sequence) -> int:
        """Upper bound on the tokens ``seq`` feeds next step — what block
        reservation must cover. A speculating decode slot may feed its
        committed token plus up to its current proposal depth; lanes that
        end up trimmed or unfilled leave blocks reserved one step early
        (reclaimed by the rollback tail trim or sequence growth)."""
        base = seq.next_feed(self.chunk_size)
        if self.spec != "off" and seq.state is SeqState.DECODE:
            return base + self._spec_depth(seq)
        return base

    def _spec_depth(self, seq: Sequence) -> int:
        """Proposal lanes this sequence wants: the controller's adaptive
        depth, capped so speculation never proposes past the sequence's
        own generation budget (the final token is always sampled by a
        plain lane)."""
        rem = seq.req.max_new_tokens - seq.tokens_out
        return max(0, min(self._spec_ctrl.depth(seq.slot),
                          rem - 1, self.chunk_size - 1))

    def _plan_step(self):
        """The step's feeds and proposals: ``plan_feeds`` (speculative
        lanes funded last), then the proposer over the budget-granted
        lanes. Lanes the proposer could not fill are zero-value evidence:
        they decay the depth EMA, so a slot with no matchable suffix stops
        reserving speculative blocks it never uses."""
        C = self.chunk_size
        if self.spec == "off":
            return self.sched.plan_feeds(C, self.step_token_budget), {}
        desires = {slot: d for slot, seq in self.sched.active.items()
                   if seq.state is SeqState.DECODE
                   and (d := self._spec_depth(seq)) > 0}
        feeds = self.sched.plan_feeds(C, self.step_token_budget, desires)
        grants = {s: feeds[s] - 1 for s in desires if feeds[s] > 1}
        proposals: Dict[int, np.ndarray] = {}
        if grants:
            # The draft drafts every slot on every replica (its rows are
            # not data-local), over the mesh's 'model' axis.
            with sharding.activation_mesh(self.mesh):
                proposals = self._proposer.propose(self.sched.active, grants)
            for slot, g in grants.items():
                got = proposals.get(slot)
                unfilled = g - (0 if got is None else int(got.size))
                if unfilled > 0:
                    self._spec_ctrl.update(slot, unfilled, 0)
        return feeds, proposals

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

    def _vision_override(self, feeds: Dict[int, int]):
        """(embeds (slots, chunk, d) bf16, mask (slots, chunk), bytes), or
        None when no prefilling vlm slot feeds a vision position this
        step: positions [fed, fed + n) below the request's vision rows
        take those rows instead of the token embedding. The bytes are
        the rows' bf16 upload."""
        ns, C = self.num_slots, self.chunk_size
        embeds = mask = None
        nbytes = 0
        for slot, seq in self.sched.active.items():
            if seq.state is not SeqState.PREFILL or not seq.req.extras:
                continue
            vis = seq.req.extras.get("vision_embeds")
            if vis is None:
                continue
            vis = torch.as_tensor(vis)[0]                 # (V, d)
            lo = seq.fed
            hi = min(seq.fed + feeds.get(slot, 0), vis.shape[0])
            if hi <= lo:
                continue
            if embeds is None:
                embeds = torch.zeros((ns, C, vis.shape[1]),
                                     dtype=torch.bfloat16, device=self.device)
                mask = torch.zeros((ns, C), dtype=torch.bool,
                                   device=self.device)
            embeds[slot, :hi - lo] = vis[lo:hi].to(self.device,
                                                   torch.bfloat16)
            mask[slot, :hi - lo] = True
            nbytes += (hi - lo) * vis.shape[1] * 2
        return None if embeds is None else (embeds, mask, nbytes)

    def _step_once(self, gen: torch.Generator, stats: GenStats,
                   ledger: TransferLedger, t0: float) -> None:
        """One unified (slots, chunk) step: prompt chunks and decode
        feedback tokens ride the same shape. Token timestamps are read
        after the step's host sync; the telemetry record (if on) is built
        on the host after it too."""
        ns, C = self.num_slots, self.chunk_size
        spec_on = self.spec != "off"
        sp = self._spans
        sp.phase("engine.plan", "host_plan_s")
        feeds, proposals = self._plan_step()
        tokens = np.zeros((ns, C), np.int32)
        pos0 = np.zeros((ns,), np.int32)
        lens = np.zeros((ns,), np.int32)
        prop_lens = np.zeros((ns,), np.int32)
        active = np.zeros((ns,), bool)
        for slot, seq in self.sched.active.items():
            n = feeds[slot]
            if seq.state is SeqState.PREFILL:
                tokens[slot, :n] = seq.req.tokens[seq.fed:seq.fed + n]
            else:
                # [last_committed, p_1, ..., p_k]
                tokens[slot, 0] = seq.next_token
                props = proposals.get(slot)
                if props is not None and props.size:
                    kp = min(int(props.size), n - 1)
                    tokens[slot, 1:1 + kp] = props[:kp]
                    prop_lens[slot] = kp
                n = 1 + int(prop_lens[slot])  # actual feed may undershoot
                feeds[slot] = n               # the plan (lanes unfilled)
            pos0[slot] = seq.position
            lens[slot] = n
            active[slot] = True
        temps, top_ks, top_ps = self._sampling_vectors(self.sched.active)

        sp.phase("engine.upload", "host_upload_s")
        t_step = time.perf_counter()
        libs0 = _build.loaded()
        dev = self.device
        lo, hi = self._rows                 # this replica's slots
        put = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
        dev_tables = None
        if self.paged:
            dev_tables, uploaded = self.arena.device_tables()
            if uploaded:        # dirty tables only: admission/growth/preempt
                ledger.charge("decode", "tables", "h2d", uploaded)
            dev_tables = dev_tables[lo:hi]
        lens_t, tokens_t = put(lens[lo:hi]), put(tokens[lo:hi])
        extra = {}
        vision = self._vision_override(feeds) if self._vlm else None
        if vision is not None:
            extra = {"embeds": vision[0][lo:hi],
                     "embeds_mask": vision[1][lo:hi]}
            ledger.charge("prefill", "acts", "h2d", vision[2])
        buffers = self.arena.buffers if self.mesh is None \
            else self.arena.local_buffers(lo, hi)
        whole = (put(pos0), put(lens)) if self.dp > 1 else None
        pos0_t = put(pos0[lo:hi])
        sp.phase("engine.model", "model_call_s")
        with sharding.activation_mesh(self.mesh, data_local=True,
                                      whole_step=whole):
            logits, _ = self.model.decode_step(
                self.params, tokens_t, pos0_t, buffers,
                quant=self.quant, block_tables=dev_tables, lengths=lens_t,
                paged_impl=self.paged_attn, **extra)
        if self.dp > 1 and self.paged:
            self.arena.sync_writes(self._step_writes(pos0, lens), self.mesh)
        sp.phase("engine.sample", "sample_s")
        # Whole-step noise (every replica draws all ns rows and keeps its
        # own), so the generator moves as on one device.
        head = dict(top_k=put(top_ks[lo:hi]), top_p=put(top_ps[lo:hi]),
                    stochastic=bool(np.any(temps > 0)),
                    step_rows=(lo, hi, ns))
        if spec_on:
            # The verify step IS the chunked step with the verification
            # head; zero proposals degenerate to plain sampling.
            nxt, acc = sampling.verify_slots(
                logits, tokens_t, gen, put(temps[lo:hi]),
                put(active[lo:hi]), prop_lens=put(prop_lens[lo:hi]),
                lengths=lens_t, **head)
            both = torch.stack([nxt, acc], dim=1)
            sp.phase("engine.readback", "readback_s")
            # One read-back: blocks until the step completes.
            nxt_host, acc_host = self._gather_slots(both).T
        else:
            idx = torch.clamp(lens_t.to(torch.long) - 1, min=0)
            last = logits[torch.arange(hi - lo, device=dev), idx]   # (B, V)
            nxt = sampling.sample_slots(last, gen, put(temps[lo:hi]),
                                        put(active[lo:hi]), **head)
            sp.phase("engine.readback", "readback_s")
            # blocks until the step completes
            nxt_host = self._gather_slots(nxt)
        sp.phase("engine.commit", "host_commit_s")
        t_end = time.perf_counter()
        now = t_end - t0
        dcomp = _build.loaded() - libs0
        self._step_compiles += dcomp

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

        resident = self.arena.resident_bytes()
        stats.peak_resident_bytes = max(stats.peak_resident_bytes, resident)
        stats.resident_bytes_sum += resident
        stats.live_tokens_sum += int(sum(
            s.position + feeds[slot]
            for slot, s in self.sched.active.items()))
        if self.paged and self.arena.has_paged:
            per_rep = self._paged_reads(pos0, lens)
            bb = self.arena.block_bytes()
            stats.paged_kv_read_bytes += float(per_rep.sum()) * bb
            stats.paged_kv_read_bytes_per_device += float(per_rep.max()) * bb
        # The contiguous arena grows by token, the paged one by block (at
        # reservation).
        tok_bytes = 0.0 if self.paged else self.arena.token_bytes()
        tl = self._timeline
        slot_mix = [] if tl is not None else None
        for slot, seq in list(self.sched.active.items()):
            n = feeds[slot]
            if seq.state is SeqState.PREFILL:
                if n == 0:
                    if slot_mix is not None:      # deferred: fed nothing
                        slot_mix.append((slot, seq.rid, "prefill", 0, 0))
                    continue                  # budget-starved this step
                stats.prefill_tokens += n
                ledger.charge_chunk("prefill", n, seq.fed + n)
                if tok_bytes:
                    ledger.charge_cache_growth("prefill", n * tok_bytes)
                first_tok = 0
                if seq.feed_chunk(n):
                    seq.start_decode()        # this chunk sampled token 0
                    if self.prefix_cache:
                        # Prefill complete: positions [0, prompt_len) are
                        # all written, decode writes land strictly past
                        # them — publish the full prompt blocks.
                        self.arena.register_prefix(seq.slot,
                                                   seq.req.tokens)
                    ledger.charge_sampled()
                    seq.record_token(int(nxt_host[slot]), now)
                    stats.decode_tokens += 1
                    first_tok = 1
                    if tl is not None:
                        tl.on_token(seq.rid, now, ttft_s=seq.ttft_s)
                        if seq.done:
                            tl.on_done(seq.rid, seq.latency_s)
                if slot_mix is not None:
                    slot_mix.append((slot, seq.rid, "prefill", n,
                                     first_tok))
            else:
                m = n                         # 1 committed + kp proposals
                kp = int(prop_lens[slot])
                ledger.charge_chunk("decode", m, int(pos0[slot]) + m)
                emitted = [int(nxt_host[slot])]
                if kp:
                    a = min(int(acc_host[slot]), kp)
                    emitted = [int(t) for t in tokens[slot, 1:1 + a]] \
                        + emitted
                    stats.spec_proposed += kp
                    stats.spec_accepted += a
                    self._spec_ctrl.update(slot, kp, a)
                r = 0
                for t in emitted:
                    if seq.done:
                        break                 # generation budget exhausted
                    first = seq.t_first_token is None
                    seq.record_token(t, now)
                    r += 1
                    if tl is not None:
                        tl.on_token(seq.rid, now,
                                    ttft_s=seq.ttft_s if first else None)
                if tl is not None and seq.done:
                    tl.on_done(seq.rid, seq.latency_s)
                if tok_bytes:
                    ledger.charge_cache_growth("decode", r * tok_bytes)
                # Host sampling would drain every fed lane's logit row
                # (rejected lanes included): charge the full feed width.
                ledger.charge_sampled(r, logit_rows=m)
                stats.decode_tokens += r
                if m > r:
                    # Rejected-suffix rollback: zero KV positions
                    # [pos0 + r, pos0 + m) and (paged) trim the table.
                    self.arena.rollback(slot, int(pos0[slot]) + r, m - r,
                                        C)
                    stats.spec_rolled_back += m - r
                if slot_mix is not None:
                    slot_mix.append((slot, seq.rid,
                                     "verify" if kp else "decode", m, r))
        stats.steps += 1
        self.sched.record_step()
        sp.close()
        if tl is not None:
            self._record_step(tl, stats, slot_mix, resident, dcomp,
                              t_step - t0, now)
        self.sched.retire(self.arena.free)

    def _record_step(self, tl: StepTimeline, stats: GenStats, slot_mix,
                     resident: float, compiles: int, t_start: float,
                     t_end: float) -> None:
        """Close the step's telemetry event with the JAX engine's counter
        keys: cumulative run-relative values, which the timeline diffs
        into per-step deltas (``draft_steps``: the draft proposer's
        rounds, with a proposer), and the port's ``TIMING_COUNTERS``, the
        phase seconds of every step so far (this one's commit included)."""
        counters = {
            "steps": float(stats.steps),
            "prefill_tokens": float(stats.prefill_tokens),
            "decode_tokens": float(stats.decode_tokens),
            "spec_proposed": float(stats.spec_proposed),
            "spec_accepted": float(stats.spec_accepted),
            "spec_rolled_back": float(stats.spec_rolled_back),
            "prefix_hits": float(stats.prefix_hits),
            "prefix_hit_tokens": float(stats.prefix_hit_tokens),
            "cow_splits": float(self.arena.cow_splits - self._run_cow0)
            if self.paged else 0.0,
            "preemptions": float(self.sched.stats.preemptions),
            "deferred_feeds": float(self.sched.stats.deferred_feeds),
            "prefill_chunks": float(self.sched.stats.prefill_chunks),
            "paged_kv_read_bytes": stats.paged_kv_read_bytes,
        }
        if self._proposer is not None:
            counters["draft_steps"] = float(
                getattr(self._proposer, "steps", 0))
        counters.update(self._spans.totals)
        tl.record_step(
            t_start=t_start, t_end=t_end,
            occupancy=len(self.sched.active), compiles=compiles,
            counters=counters,
            gauges={"resident_bytes": float(resident),
                    "queue_len": float(len(self.sched.queue))},
            slots=slot_mix)

    def _paged_reads(self, pos0: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Pages the step's attention reads, per 'data' replica (the
        busiest one's is the per-device figure, as in the JAX engine)."""
        ns = self.num_slots
        bsz, mb = self.arena.block_size, self.arena.max_blocks
        rep_sz = ns // self.dp
        per_rep = np.zeros((self.dp,))
        if self.paged_attn == "fused":
            # The kernel's page reads: a slot row walks blocks
            # 0..(pos0 + max(lengths,1) - 1)//bs, counted as distinct
            # consecutive pages as the JAX ledger does (an idle slot's
            # all-null row costs one null-page read).
            tb = self.arena.tables
            for s in range(ns):
                depth = int(pos0[s]) + max(int(lens[s]), 1) - 1
                walk = tb[s, :min(depth // bsz, mb - 1) + 1]
                per_rep[s // rep_sz] += 1 + int(np.sum(walk[1:] != walk[:-1]))
        else:
            per_rep[:] = rep_sz * mb    # dense gather of every table row
        return per_rep

    def _step_writes(self, pos0: np.ndarray, lens: np.ndarray):
        """Per 'data' replica, the (page, offset) pairs its slots' valid
        chunk entries wrote this step, routed as ``attention._routing``
        routes them (from the host tables the step ran with)."""
        bs, mb = self.arena.block_size, self.arena.max_blocks
        rep = self.num_slots // self.dp
        out = []
        for r in range(self.dp):
            pages, offs = [np.zeros((0,), np.int64)], [np.zeros((0,),
                                                                np.int64)]
            for s in range(r * rep, (r + 1) * rep):
                pos = int(pos0[s]) + np.arange(int(lens[s]))
                pages.append(self.arena.tables[s, np.minimum(pos // bs,
                                                             mb - 1)])
                offs.append(pos % bs)
            out.append((np.concatenate(pages), np.concatenate(offs)))
        return out

    def _gather_slots(self, x: torch.Tensor) -> np.ndarray:
        """A per-slot result of this replica's slots as the host array of
        every slot: all-gathered over 'data' under a mesh (every rank's
        scheduler then advances the same way). The step's one read-back:
        blocks until the step completes."""
        if self.dp > 1:
            x = self.mesh.all_gather(x, "data", 0)
        return x.cpu().numpy()

    # ------------------------------------------------------------------
    def serve(self, requests: List[Request], *, seed: int = 0,
              realtime: bool = True) -> ServeReport:
        """Run a request stream to completion. ``realtime``: honor
        ``arrival_s`` offsets against the wall clock (sleep while idle);
        False replays arrivals against the virtual step clock only.
        Each run gets a fresh scheduler; the arena is reused (its tables
        are empty between runs), so with ``prefix_cache`` the pages one
        run published are hit by the next. ``reset()`` drops them."""
        if self.sched.stats.steps or self.sched.finished:
            self.sched = Scheduler(self.num_slots, self.max_seq, dp=self.dp)
            self._pending_prefix.clear()
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
        reset_run = getattr(self._proposer, "reset_run", None)
        if reset_run is not None:
            reset_run()             # fresh draft ledger per serve run
        stats = GenStats()
        ledger = TransferLedger(self.model.cfg, self.quant,
                                **self._ledger_kw)
        # The arena (and its prefix cache) outlives serve() runs, so
        # per-run CoW counts are deltas.
        cow0 = self.arena.cow_splits if self.paged else 0
        self._run_cow0 = cow0
        tl = None
        if self.telemetry:
            # Built AFTER the proposer's reset_run, so the draft tap lands
            # on this run's fresh draft ledger; detached again by
            # finalize() before the report is built.
            tl = StepTimeline(
                ledger,
                draft_ledger=getattr(self._proposer, "ledger", None),
                meta={"arch": self.model.cfg.name, "quant": self.quant,
                      "slots": self.num_slots, "chunk": self.chunk_size,
                      "dp": self.dp, "tp": self.tp, "spec": self.spec,
                      "kv_quant": self.kv_quant, "paged": self.paged})
            self._timeline = tl
            self.sched.telemetry = tl
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.mesh is not None:
            self.mesh.reset_stats()
        t0_ns = time.perf_counter_ns()
        t0 = t0_ns / 1e9
        sp = _NO_SPANS
        if tl is not None:
            # The serve's start on the profiler's clock (the Unix epoch).
            tl.meta["t0_unix_ns"] = time.time_ns() \
                - (time.perf_counter_ns() - t0_ns)
            sp = _Spans(tl, t0_ns)
        self._spans = sp

        while self.sched.has_work:
            now = time.perf_counter() - t0
            if self.sched.active:
                sp.open_step()
            if self.paged:
                # Incumbents reserve their next-feed blocks BEFORE new
                # admissions take them (may preempt-to-queue).
                sp.phase("engine.reserve", "host_reserve_s")
                self._reserve_blocks(ledger)
            sp.phase("engine.admit", "host_admit_s")
            admitted = self.sched.admit(self._try_admit, now)
            for seq in admitted:
                self._admit_chunked(seq, stats, ledger)
            sp.close(admitted)
            if self.sched.active:
                sp.open_step()      # the first step after an idle spell
                self._step_once(gen, stats, ledger, t0)
                sp.close_step()
                continue
            sp.close_step()     # reservation preempted every active sequence
            if self.sched.queue:
                continue        # preempted/starved: blocks freed, re-admit
            nxt = self.sched.next_arrival()
            if nxt is None:
                break
            sp.phase("engine.wait")
            if realtime:
                time.sleep(min(max(nxt - now, 0.0), 0.05))
            else:
                self.sched.poll_arrivals(float("inf"))
            sp.close()

        wall = time.perf_counter() - t0
        if tl is not None:
            tl.finalize(wall)
            self._timeline = None
            self._spans = _NO_SPANS
            self.sched.telemetry = None
        stats.cache_bytes = self.arena.nbytes()
        if self.paged:
            stats.cow_splits = self.arena.cow_splits - cow0
        stats.transfers = TransferReport.from_ledger(ledger)
        draft_ledger = getattr(self._proposer, "ledger", None)
        if draft_ledger is not None:
            stats.draft_transfers = TransferReport.from_ledger(draft_ledger)
        order = {r.rid: i for i, r in enumerate(requests)}
        seqs = sorted(self.sched.finished, key=lambda s: order[s.rid])
        return ServeReport(stats=stats, sequences=seqs,
                           sched=self.sched.stats, wall_s=wall,
                           ledger=ledger,
                           step_compiles=self._step_compiles, timeline=tl,
                           collectives=None if self.mesh is None
                           else dict(self.mesh.stats))


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
                 top_p: float = 1.0, seed: int = 0,
                 extras: Optional[Dict] = None):
        """tokens: (B, S_prompt) int (numpy or tensor); ``extras``: batched
        frontend inputs ({"frames": (B, ...)} / {"vision_embeds": ...}),
        row i going to request i. Returns (out_tokens (B, T) int32 numpy,
        stats)."""
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
                        sampling=samp,
                        extras={k: v[i:i + 1] for k, v in extras.items()}
                        if extras else None) for i in range(b)]
        try:
            report = eng.serve(reqs, seed=seed, realtime=False)
        finally:
            eng.arena = eng.sched = None    # a full-size arena is large
        out = np.stack([np.asarray(q.generated, np.int32)
                        for q in report.sequences])
        return out, report.stats
