"""Host<->accelerator transfer ledger for the live serving runtime.

Copied from ``repro.runtime.transfers`` (it is plain Python over the
``core/offload.py`` byte accounting); only the analytic bucketed-replay
helper stays behind, since no port code or test replays the retired
bucketed engine.

The paper's system-level finding (§V.A, Table 2) is that data transfer —
not kernel throughput — bounds LLM inference on the CGLA. The offline
analytical model (`core/offload.py`) always knew this; the live engine
never accounted a byte. This ledger charges every host<->device movement
of a generation to a (phase, category, direction) cell:

  phase      prefill | decode            (paper Fig. 15a vs 15b)
  category   tokens  — prompt/feedback token ids, h2d
             weights — offloaded kernel weight staging (DMA LOAD). Under
                       the live chunked charging this is the *linear*
                       weight stream only (once per step, shared by every
                       slot) — the lever speculative verification
                       amortizes; the analytic single-stream replay keeps
                       the legacy combined meaning (linear + KV)
             kv_stream — the fp16 attention calls' per-slot KV cache
                       stream (attn_qk / attn_pv "weights"), split out so
                       bytes/token decomposes into the shareable weight
                       stream vs the per-token KV traffic (live chunked
                       charging only). Under ``kv_quant="int8"`` the
                       stream is scaled by ``kv_quant_stream_scale`` —
                       int8 codes plus one fp16 scale per (position,
                       kv-head) instead of 2-byte elements
             acts    — activation staging for offloaded kernels, h2d
             outs    — kernel result drain, d2h
             sampled — sampled token ids, d2h (fused device sampling), or
             logits  — full logit rows, d2h (llama.cpp-style host sampling)
             tables  — paged-arena block-table uploads, h2d (charged only
                       when the tables actually changed: admission, block
                       growth, preemption — not per step)
             kv_arena— device-resident cache growth (informational; not a
                       host<->device transfer). Slot arena: token-granular
                       per decode step; paged arena: block-granular at
                       reservation time (admission + boundary crossings),
                       so bytes-resident tracks actual block occupancy
  direction  h2d | d2h | dev

Two charging schemes share the ledger:

* analytic single-stream (``charge_prefill`` + ``charge_decode_step``):
  one whole-prompt prefill pass and a full per-sequence weight stream
  every decode step — the paper's single-request llama.cpp execution
  model. The serving engine no longer runs this way (the bucketed
  prefill path was retired); these charges remain the *offline* replay
  used by bench_e2e_latency.py and the modeled-bucketed comparison in
  bench_serving.py.
* unified chunked step (``charge_step_weights`` + ``charge_chunk`` +
  ``charge_sampled``) — what the live engine charges: the quantized
  *linear* weights stream once per step — every slot's chunk shares the
  pass — while per-slot charges cover exactly the tokens actually fed
  (token ids, activation staging, output drain, and the slot's own KV
  stream). No pow2 padding bytes, no N-times-replicated weight stream:
  this is what makes chunked prefill's bytes/token measurably lower at
  equal workload in bench_serving.py.

Kernel-byte math comes from `core/offload.py`'s ``KernelCall`` accounting
(`phase_transfer_bytes` / `model_kernel_calls`), optionally filtered by
an ``OffloadPolicy`` decision table so host-resident kernels charge
nothing — the live analog of Table 2's per-format offload ratios.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coalesce import TransferModel
from repro_torch.core.offload import model_kernel_calls, phase_transfer_bytes
from repro_torch.core.quant.formats import RECIPES

# The fp16 attention calls whose "weights" are the KV-cache stream —
# per-slot traffic, never shared across a batched step.
_KV_STREAM_CALLS = ("attn_qk", "attn_pv")

H2D = "h2d"
D2H = "d2h"
DEV = "dev"
PHASES = ("prefill", "decode")


def kv_quant_stream_scale(cfg: ModelConfig, kv_quant: str) -> float:
    """Bytes ratio of the quantized KV stream to the bf16 stream.

    The KernelCall tables charge attention KV at fp16 width (2 bytes per
    element). ``kv_quant="int8"`` stores each element as a 1-byte code
    plus one fp16 scale per (position, kv-head) — i.e. per trailing
    feature axis of the paged leaf. Per position and kv-head:

    * GQA: ``(head_dim + 2) / (2 * head_dim)`` — head_dim codes + one
      2-byte scale vs head_dim 2-byte elements (K and V scale alike, so
      the factor applies to the whole stream).
    * absorbed MLA: the per-position stream is the compressed KV
      (``kv_lora_rank`` elements) plus the decoupled-RoPE key
      (``qk_rope_head_dim`` elements), each with its own scale:
      ``((rank + 2) + (rope + 2)) / (2 * (rank + rope))``.

    Returns 1.0 for ``kv_quant="none"``. See ``docs/transfer-ledger.md``.
    """
    if kv_quant == "none":
        return 1.0
    if kv_quant != "int8":
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
    if cfg.mla is not None:
        rank, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
        return ((rank + 2) + (rope + 2)) / (2.0 * (rank + rope))
    hd = cfg.resolved_head_dim()
    return (hd + 2) / (2.0 * hd)


class TransferLedger:
    """Accumulates per-phase host<->device bytes for one serving run."""

    def __init__(self, cfg: ModelConfig, quant: str, *,
                 decisions: Optional[Dict[str, bool]] = None,
                 host_sampling: bool = False, kv_quant: str = "none",
                 dp: int = 1, tp: int = 1):
        if dp < 1 or tp < 1:
            raise ValueError(f"mesh degrees must be >= 1, got dp={dp} "
                             f"tp={tp}")
        self.cfg = cfg
        # Dense bf16 serving ("none") is accounted at 16-bit weight width —
        # the KernelCall tables only know the llama.cpp transfer formats.
        self.quant = quant if quant in RECIPES else "fp16"
        self.decisions = decisions
        self.host_sampling = host_sampling
        self.kv_quant = kv_quant
        # Serving-mesh degrees: every charge keeps recording the
        # *mesh-total* bytes (so all aggregate views and their committed
        # baselines are degree-invariant); the per_device_* views divide
        # each category by the axis it physically shards over.
        self.dp = dp
        self.tp = tp
        # Multiplied into every kv_stream charge: the quantized paged
        # arena streams int8 codes + fp16 scales instead of bf16 pages.
        self._kv_stream_scale = kv_quant_stream_scale(cfg, kv_quant)
        # {phase: {category: {direction: bytes}}}
        self._cells: Dict[str, Dict[str, Dict[str, float]]] = {}
        # Charge tap (telemetry.StepTimeline): observes every charge in
        # fold order, so an external accumulator can mirror the cells
        # bit-exactly. None when no observer is attached.
        self._tap: Optional[Callable[[str, str, str, float], None]] = None
        self.tokens: Dict[str, int] = {p: 0 for p in PHASES}
        # Prompt positions satisfied from shared prefix-cache pages:
        # never streamed, never computed — the whole point of prefix
        # sharing is that these charge NOTHING to the h2d cells (their
        # KV reaches the step as a block-table entry, accounted under
        # "tables"). Tallied so hit ratios can be reported.
        self.prefix_hit_tokens: int = 0

    # -- raw charge ------------------------------------------------------
    def charge(self, phase: str, category: str, direction: str,
               nbytes: float) -> None:
        """Add ``nbytes`` to the (phase, category, direction) cell.

        The single entry point for ALL byte accounting — every wrapper
        (chunk charges, cache growth, table uploads, sampled drains)
        lands here, so the attached tap (if any) observes the complete
        charge stream in cell-fold order: an accumulator driven by the
        tap with the same per-charge additions reproduces the cells
        bit-exactly (the telemetry closure guarantee)."""
        nbytes = float(nbytes)
        by_cat = self._cells.setdefault(phase, {})
        by_dir = by_cat.setdefault(category, {})
        by_dir[direction] = by_dir.get(direction, 0.0) + nbytes
        if self._tap is not None:
            self._tap(phase, category, direction, nbytes)

    def attach_tap(self, fn: Callable[[str, str, str, float], None]
                   ) -> None:
        """Attach a charge observer called as ``fn(phase, category,
        direction, nbytes)`` on every charge. One observer at a time —
        attaching over a live tap raises (a silently replaced tap would
        break the first observer's closure guarantee)."""
        if self._tap is not None:
            raise RuntimeError("TransferLedger already has a tap "
                               "attached; detach it first")
        self._tap = fn

    def detach_tap(self) -> None:
        """Remove the charge observer (no-op when none is attached)."""
        self._tap = None

    def flat_cells(self) -> Dict[Tuple[str, str, str], float]:
        """Cheap flat snapshot: {(phase, category, direction): bytes}.
        The delta of two snapshots is a between-points byte breakdown;
        for *bit-exact* series use the tap (float addition does not
        telescope exactly across snapshot diffs)."""
        return {(p, c, d): b
                for p, cats in self._cells.items()
                for c, by_dir in cats.items()
                for d, b in by_dir.items()}

    # -- phase-level charges ---------------------------------------------
    def charge_prefill(self, seq: int, batch: int = 1) -> None:
        """One prompt prefill of ``seq`` tokens (post-bucketing length)."""
        self.charge("prefill", "tokens", H2D, batch * seq * 4)
        kb = phase_transfer_bytes(self.cfg, self.quant, seq, batch,
                                  decode=False, decisions=self.decisions)
        self.charge("prefill", "weights", H2D, kb["weights"])
        self.charge("prefill", "acts", H2D, kb["acts"])
        self.charge("prefill", "outs", D2H, kb["outs"])
        self.tokens["prefill"] += batch * seq

    def charge_decode_step(self, kv_len: int, batch: int = 1) -> None:
        """One decode step for ``batch`` sequences at KV depth ``kv_len``."""
        self.charge("decode", "tokens", H2D, batch * 4)
        kb = phase_transfer_bytes(self.cfg, self.quant, kv_len, batch,
                                  decode=True, decisions=self.decisions)
        self.charge("decode", "weights", H2D, kb["weights"])
        self.charge("decode", "acts", H2D, kb["acts"])
        self.charge("decode", "outs", D2H, kb["outs"])
        if self.host_sampling:
            self.charge("decode", "logits", D2H,
                        batch * self.cfg.vocab_size * 4)
        else:
            self.charge("decode", "sampled", D2H, batch * 4)
        self.tokens["decode"] += batch

    def charge_cache_growth(self, phase: str, nbytes: float) -> None:
        """KV bytes newly written into the device-resident arena (a
        capacity cell, not a PCIe transfer — excluded from h2d/d2h
        totals)."""
        self.charge(phase, "kv_arena", DEV, nbytes)

    def record_prefix_hit(self, tokens: int) -> None:
        """``tokens`` prompt positions admitted onto shared pages — a
        stat, not a byte charge (nothing moved)."""
        self.prefix_hit_tokens += int(tokens)

    # -- unified-chunked-step charges -------------------------------------
    def _split_kernel_bytes(self, kv_len: int, new_tokens: int):
        """(linear_weights, kv_stream, acts, outs) bytes for ``new_tokens``
        queries against a ``kv_len``-deep KV — one slot's share of a
        unified step. Linear weights are returned separately because the
        step streams them once for ALL slots (``charge_step_weights``)."""
        w_lin = w_kv = a = o = 0.0
        for c in model_kernel_calls(self.cfg, self.quant, kv_len,
                                    new_tokens, decode=True):
            if self.decisions is not None and \
                    not self.decisions.get(c.name, True):
                continue
            if c.name in _KV_STREAM_CALLS:
                w_kv += c.weight_bytes
            else:
                w_lin += c.weight_bytes
            a += c.act_bytes
            o += c.out_bytes
        return w_lin, w_kv, a, o

    def charge_step_weights(self, prefill_frac: float = 0.0) -> None:
        """One unified step's shared quantized-weight stream (charged once
        per step, not per slot — the whole (slots, chunk) batch rides one
        pass through the model). ``prefill_frac``: fraction of the step's
        valid tokens that were prompt chunks — the stream is attributed
        pro-rata so phase totals stay meaningful."""
        w_lin, _, _, _ = self._split_kernel_bytes(1, 1)
        if prefill_frac > 0.0:
            self.charge("prefill", "weights", H2D, w_lin * prefill_frac)
        if prefill_frac < 1.0:
            self.charge("decode", "weights", H2D,
                        w_lin * (1.0 - prefill_frac))

    def charge_chunk(self, phase: str, new_tokens: int,
                     kv_len: int) -> None:
        """One slot's chunk inside a unified step: exactly ``new_tokens``
        token ids + activation staging in, output drain out, plus the
        slot's own KV stream at depth ``kv_len``. Prefill chunks count
        toward the prefill token tally; decode feedback tokens are counted
        by ``charge_sampled`` (one per *generated* token), keeping
        bytes_per_token's denominator comparable with the analytic
        single-stream replay."""
        self.charge(phase, "tokens", H2D, new_tokens * 4)
        _, w_kv, a, o = self._split_kernel_bytes(kv_len, new_tokens)
        self.charge(phase, "kv_stream", H2D, w_kv * self._kv_stream_scale)
        self.charge(phase, "acts", H2D, a)
        self.charge(phase, "outs", D2H, o)
        if phase == "prefill":
            self.tokens["prefill"] += new_tokens

    def charge_sampled(self, n: int = 1,
                       logit_rows: Optional[int] = None) -> None:
        """``n`` generated tokens committed (the per-token denominator).
        d2h side: the fused device sampler drains ``n`` token ids; host
        sampling drains full logit rows — ``logit_rows`` of them
        (defaults to ``n``; a speculative verify step must drain *every
        fed lane's* row, accepted or rejected, so the engine passes the
        full feed width there)."""
        if self.host_sampling:
            rows = n if logit_rows is None else logit_rows
            self.charge("decode", "logits", D2H,
                        rows * self.cfg.vocab_size * 4)
        else:
            self.charge("decode", "sampled", D2H, n * 4)
        self.tokens["decode"] += n

    # -- views -----------------------------------------------------------
    def breakdown(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Deep copy of the {phase: {category: {direction: bytes}}} cells."""
        return {p: {c: dict(d) for c, d in cats.items()}
                for p, cats in self._cells.items()}

    def phase_bytes(self, phase: str) -> Dict[str, float]:
        """{h2d, d2h} totals for a phase (device-resident cells excluded)."""
        out = {H2D: 0.0, D2H: 0.0}
        for by_dir in self._cells.get(phase, {}).values():
            for d, b in by_dir.items():
                if d in out:
                    out[d] += b
        return out

    def total(self, direction: str) -> float:
        """Bytes moved in ``direction`` (h2d or d2h) across all phases."""
        return sum(self.phase_bytes(p)[direction] for p in self._cells)

    def category_bytes(self, category: str) -> float:
        """Bytes charged to one category across phases and directions."""
        return sum(b for cats in self._cells.values()
                   for cat, by_dir in cats.items() if cat == category
                   for b in by_dir.values())

    def weight_stream_bytes(self) -> float:
        """The quantized linear-weight DMA stream (the dominant,
        step-amortizable term under the chunked charging — what
        speculative verification divides by the accept length)."""
        return self.category_bytes("weights")

    def kv_stream_bytes(self) -> float:
        """Per-slot KV cache stream of the fp16 attention calls (grows
        with live context; not amortizable across slots or steps)."""
        return self.category_bytes("kv_stream")

    def weight_stream_bytes_per_token(self) -> float:
        """Weight-stream bytes per *generated* token — proportional to
        steps-per-token, hence the speculative-decoding acceptance
        metric: k accepted tokens per verify step divide one stream."""
        return self.weight_stream_bytes() / max(self.tokens["decode"], 1)

    def bytes_per_token(self) -> float:
        """Transferred bytes (both directions) per generated token."""
        n = max(self.tokens["decode"], 1)
        return (self.total(H2D) + self.total(D2H)) / n

    # -- per-device views (serving mesh accounting) ----------------------
    def device_share(self, category: str) -> float:
        """Fraction of a category's mesh-total bytes one device moves.

        ``weights`` shard over the 'model' axis (each device streams its
        out-feature slice of every linear, replicated across 'data'
        replicas), so its share is ``1/tp``. Every other category —
        token ids, the per-slot KV stream, activation staging, output
        drains, sampled ids/logit rows, block-table uploads, and arena
        growth — follows the slots, which partition over 'data': one
        replica moves its slots' share ``1/dp`` and the 'model' axis
        replicates it. Summing a category's per-device bytes over the
        axis it shards on therefore recovers the mesh total exactly
        (the closure property pinned in tests)."""
        return 1.0 / self.tp if category == "weights" else 1.0 / self.dp

    def per_device_breakdown(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Per-device {phase: {category: {direction: bytes}}} cells."""
        return {p: {c: {d: b * self.device_share(c)
                        for d, b in by_dir.items()}
                    for c, by_dir in cats.items()}
                for p, cats in self._cells.items()}

    def per_device_phase_bytes(self, phase: str) -> Dict[str, float]:
        """{h2d, d2h} totals one device moves for a phase."""
        out = {H2D: 0.0, D2H: 0.0}
        for cat, by_dir in self._cells.get(phase, {}).items():
            share = self.device_share(cat)
            for d, b in by_dir.items():
                if d in out:
                    out[d] += b * share
        return out

    def per_device_total(self, direction: str) -> float:
        """Bytes one device moves in ``direction`` across all phases."""
        return sum(self.per_device_phase_bytes(p)[direction]
                   for p in self._cells)

    def per_device_weight_stream_bytes_per_token(self) -> float:
        """One device's linear weight-stream bytes per generated token —
        the tensor-parallel scaling headline: the stream divides by tp
        while the (replicated-per-replica) token count does not."""
        return self.weight_stream_bytes_per_token() * self.device_share(
            "weights")

    def per_device_bytes_per_token(self) -> float:
        """One device's transferred bytes per generated token."""
        n = max(self.tokens["decode"], 1)
        return (self.per_device_total(H2D)
                + self.per_device_total(D2H)) / n

    def load_seconds(self, tm: Optional[TransferModel] = None,
                     coalesced: bool = True) -> Dict[str, float]:
        """Modeled DMA time per phase (Fig. 15 LOAD/DRAIN analog), using
        the calibrated coalescing transfer model."""
        tm = tm or TransferModel()
        out = {}
        for p in self._cells:
            pb = self.phase_bytes(p)
            out[p] = tm.load_time([pb[H2D]], coalesced) \
                + tm.drain_time(pb[D2H], coalesced)
        return out

    def summary_lines(self, exec_s: Optional[Dict[str, float]] = None):
        """Fig. 15-style LOAD vs EXEC lines; ``exec_s``: measured wall time
        per phase from GenStats."""
        lines = []
        load = self.load_seconds()
        for p in PHASES:
            if p not in self._cells:
                continue
            pb = self.phase_bytes(p)
            line = (f"{p:7s} h2d {pb[H2D]/1e6:10.2f} MB | "
                    f"d2h {pb[D2H]/1e6:8.3f} MB | "
                    f"modeled LOAD {load[p]*1e3:8.2f} ms")
            if exec_s and exec_s.get(p):
                e = exec_s[p]
                frac = load[p] / (load[p] + e)
                line += f" | measured EXEC {e*1e3:8.2f} ms" \
                        f" | LOAD share {frac*100:5.1f}%"
            lines.append(line)
        lines.append(f"bytes/generated-token: {self.bytes_per_token()/1e6:.3f} MB")
        # Per-device figures are NOT repeated here: the serve report's
        # mesh line (telemetry.serve_report_lines) is their one home —
        # the two used to drift.
        return lines


@dataclasses.dataclass
class TransferReport:
    """Frozen ledger view attached to GenStats."""
    breakdown: Dict[str, Dict[str, Dict[str, float]]]
    phase_totals: Dict[str, Dict[str, float]]
    bytes_per_token: float
    weight_stream_bytes: float = 0.0
    kv_stream_bytes: float = 0.0
    weight_stream_bytes_per_token: float = 0.0
    prefix_hit_tokens: int = 0
    dp: int = 1
    tp: int = 1
    per_device_bytes_per_token: float = 0.0
    per_device_weight_stream_bytes_per_token: float = 0.0

    @classmethod
    def from_ledger(cls, ledger: TransferLedger) -> "TransferReport":
        """Snapshot a live ledger into an immutable report."""
        return cls(breakdown=ledger.breakdown(),
                   phase_totals={p: ledger.phase_bytes(p)
                                 for p in ledger.breakdown()},
                   bytes_per_token=ledger.bytes_per_token(),
                   weight_stream_bytes=ledger.weight_stream_bytes(),
                   kv_stream_bytes=ledger.kv_stream_bytes(),
                   weight_stream_bytes_per_token=(
                       ledger.weight_stream_bytes_per_token()),
                   prefix_hit_tokens=ledger.prefix_hit_tokens,
                   dp=ledger.dp, tp=ledger.tp,
                   per_device_bytes_per_token=(
                       ledger.per_device_bytes_per_token()),
                   per_device_weight_stream_bytes_per_token=(
                       ledger.per_device_weight_stream_bytes_per_token()))
