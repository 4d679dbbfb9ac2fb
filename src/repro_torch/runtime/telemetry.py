"""Per-step serving telemetry: step timeline, streaming percentiles,
Perfetto trace export, and transfer-bottleneck attribution.

The paper's system-level finding (§V.A) is that host<->accelerator data
transfer — not kernel execution — bounds LLM inference on the CGLA. The
``TransferLedger`` counts those bytes; this module shows *when* they
land, how transfer interleaves with compute, and which phase dominates a
live serve, so every perf claim ships with a per-step evidence trail
instead of two summary numbers. Strictly host-side: telemetry never
touches a device tensor, adds no synchronisation and launches no kernel,
so the emitted tokens and every kernel's launch count are identical with
it on or off.

This is the port of ``repro.runtime.telemetry``; it imports only
``core/coalesce`` and ``runtime/transfers``, and its JSONL schema
(``METRICS_SCHEMA``) and trace layout are the JAX package's, key for
key. One field reads differently: the JAX step's ``compiles`` is the
growth of its jit cache during the step. The port's step runs eagerly,
so its analogue is the number of kernel libraries that
``kernels/_build.py`` built or loaded during the step: 1 or more on a
step that reached a kernel for the first time in the process, 0 once
warm, and always 0 on the CPU path (which launches no kernel).

``load_s`` and ``bound`` are the JAX package's too: ``load_s`` is the
ledger's *modeled* DMA time of the step's bytes on the paper's CGLA
(``TransferModel``, 3.2 GB/s plus a per-transaction setup), not traffic
measured on the card running the port, so ``bound`` compares a modeled
CGLA LOAD with the measured step of whatever device served it.

Pieces:

* ``LogHistogram`` — fixed-bin log histogram: a mergeable streaming
  percentile estimator with bounded relative error (one bin width),
  replacing ad-hoc latency lists. Used for TTFT, inter-token latency,
  queue wait, request latency and step wall-clock.
* ``StepEvent`` / ``StepTimeline`` — one structured event per engine
  step: phase mix per slot, occupancy, wall-clock, jit-compile events,
  preemptions, speculative and prefix-sharing counter deltas, and the
  *delta* of every TransferLedger (phase, category, direction) cell.
  Deltas are captured through the ledger's charge tap (see
  ``TransferLedger.attach_tap``), so the timeline's accumulated cells
  close bit-exactly against ``ledger.breakdown()`` — every charge path
  (admission growth, preemption, rollback, prefix hits, draft account)
  flows through the same tap.
* Exporters — a JSONL metrics sink (schema below, validated by
  ``validate_metrics_jsonl``) and a Chrome-trace/Perfetto JSON export
  (``write_chrome_trace``): steps as spans on per-slot tracks plus
  ledger byte counter tracks, droppable into https://ui.perfetto.dev.
* ``BottleneckReport`` — per-step transfer-bound vs compute-bound
  attribution: the modeled DMA time of the step's delta bytes
  (``TransferModel``, the bench's LOAD model) against the measured step
  wall-clock (EXEC) — the paper's LOAD-vs-EXEC analysis reproduced from
  live runs, with per-device figures under ``--dp``/``--tp``.
* ``serve_report_lines`` — the ONE formatter behind serve.py's report
  and the ledger/prefix summary, so the two report paths cannot drift.
* ``Span`` / ``TIMING_COUNTERS`` — the port's own: the engine's named
  spans (``engine.step`` and its phases, ``engine.wait``; kept on the
  timeline, ns from the serve's start) and the eight phase-seconds
  counters every step event carries. The engine records them
  (``runtime/engine.py``); the JSONL keeps the counters, the Chrome
  trace the spans, and the meta's ``t0_unix_ns`` lays both over a
  ``torch.profiler`` trace.

JSONL event schema (one JSON object per line, ``"event"`` discriminates;
see docs/observability.md for the full field glossary):

  meta     run header: arch/quant/slots/chunk/dp/tp/spec/kv_quant
  admit    {rid, t, queue_wait_s}
  preempt  {rid, t}
  step     {step, t_start, t_end, wall_s, occupancy, compiles,
            counters, gauges, slots, ledger_delta, draft_delta,
            load_s, bound}
  summary  {steps, histograms, percentiles, bottleneck, ledger_total}
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.coalesce import TransferModel
from repro_torch.runtime.transfers import (D2H, H2D, PHASES, TransferLedger)

# Cell key: (phase, category, direction) — the ledger's grid flattened.
CellKey = Tuple[str, str, str]

#: JSONL event types and the keys every instance must carry.
METRICS_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "meta": ("version", "ts_unit"),
    "admit": ("rid", "t", "queue_wait_s"),
    "preempt": ("rid", "t"),
    "step": ("step", "t_start", "t_end", "wall_s", "occupancy",
             "compiles", "counters", "gauges", "slots", "ledger_delta",
             "load_s", "bound"),
    "summary": ("steps", "histograms", "percentiles", "bottleneck",
                "ledger_total"),
}


#: Cumulative seconds of the engine step's phases, on every step event's
#: ``counters`` (so each event holds its own step's phase times): the
#: host's work between model calls (reserve, admit, plan, upload,
#: commit), the model call's launches, sampling and the read-back.
TIMING_COUNTERS: Tuple[str, ...] = (
    "host_reserve_s", "host_admit_s", "host_plan_s", "host_upload_s",
    "model_call_s", "sample_s", "readback_s", "host_commit_s")


class Span(NamedTuple):
    """One named interval of the serve loop (the engine's ``_Spans``)."""

    name: str                       # engine.step, engine.plan, ...
    step: int                       # the step it belongs to, or precedes
    parent: Optional[str]           # "engine.step" for a step's phases
    t_start_ns: int                 # ns since the serve's start
    t_end_ns: int
    rids: Tuple[int, ...] = ()      # requests admitted (engine.admit)


def _cell_str(key: CellKey) -> str:
    """``(phase, cat, dir)`` -> the JSONL's ``"phase/cat/dir"`` key."""
    return "/".join(key)


class LogHistogram:
    """Fixed-bin log-spaced histogram: a mergeable streaming quantile
    estimator.

    Values land in geometrically spaced bins between ``lo`` and ``hi``
    (``bins_per_decade`` per factor of 10), so a percentile estimate is
    off by at most one bin width — a bounded *relative* error of
    ``10**(1/bins_per_decade) - 1`` (~10% at the default 24/decade,
    halved in expectation by the geometric-midpoint readout) regardless
    of how many samples stream through. Constant memory, O(1) record,
    mergeable across histograms with identical bin geometry (shard-local
    telemetry can be reduced without keeping raw samples).

    Values below ``lo`` (including 0 — e.g. same-step inter-token gaps
    from accepted speculative lanes) fall into a dedicated underflow
    bin; values at or above ``hi`` into an overflow bin. Exact ``min``,
    ``max``, ``sum`` and ``count`` ride along, and percentile readouts
    are clamped to the observed [min, max].
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e5,
                 bins_per_decade: int = 24):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo, self.hi = float(lo), float(hi)
        self.bins_per_decade = int(bins_per_decade)
        decades = math.log10(self.hi / self.lo)
        # +2: underflow bin 0, overflow bin nbins-1.
        self._nbins = int(math.ceil(decades * bins_per_decade)) + 2
        self._counts = [0] * self._nbins
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bin_of(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._nbins - 1
        return 1 + int(math.log10(v / self.lo) * self.bins_per_decade)

    def _edges(self, b: int) -> Tuple[float, float]:
        """[lower, upper) value edges of interior bin ``b``."""
        lo = self.lo * 10.0 ** ((b - 1) / self.bins_per_decade)
        hi = self.lo * 10.0 ** (b / self.bins_per_decade)
        return lo, hi

    def record(self, v: float) -> None:
        """Stream one value in (O(1), no allocation)."""
        v = float(v)
        b = self._bin_of(v)
        self._counts[min(b, self._nbins - 1)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def merge(self, other: "LogHistogram") -> None:
        """Fold ``other``'s mass into this histogram (same geometry)."""
        if (other.lo, other.hi, other.bins_per_decade) != \
                (self.lo, self.hi, self.bins_per_decade):
            raise ValueError("cannot merge histograms with different "
                             "bin geometry")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for attr in ("min", "max"):
            o = getattr(other, attr)
            if o is None:
                continue
            s = getattr(self, attr)
            pick = min if attr == "min" else max
            setattr(self, attr, o if s is None else pick(s, o))

    @property
    def mean(self) -> float:
        """Exact arithmetic mean of the recorded values."""
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank ``q``-th percentile estimate.

        Walks the cumulative counts to the bin holding rank
        ``ceil(q/100 * count)`` and reads its geometric midpoint,
        clamped to the observed [min, max] — so the estimate is within
        one bin width (relative) of the exact nearest-rank quantile.
        """
        if not self.count:
            return 0.0
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        acc = 0
        for b, c in enumerate(self._counts):
            acc += c
            if acc >= rank:
                if b == 0:                       # underflow: all < lo
                    v = self.min if self.min is not None else 0.0
                elif b == self._nbins - 1:       # overflow: all >= hi
                    v = self.max if self.max is not None else self.hi
                else:
                    lo, hi = self._edges(b)
                    v = math.sqrt(lo * hi)
                return min(max(v, self.min), self.max)
        return self.max                           # pragma: no cover

    def percentiles(self, qs: Sequence[float] = (50, 90, 99)
                    ) -> Dict[str, float]:
        """{"p50": ..., ...} for each requested percentile."""
        return {f"p{g:g}": self.percentile(g) for g in qs}

    def to_dict(self) -> Dict:
        """JSON-ready state (sparse bins), invertible by ``from_dict``."""
        return {"lo": self.lo, "hi": self.hi,
                "bins_per_decade": self.bins_per_decade,
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "bins": {str(i): c for i, c in enumerate(self._counts)
                         if c}}

    @classmethod
    def from_dict(cls, d: Dict) -> "LogHistogram":
        """Rebuild a histogram from its ``to_dict`` form."""
        h = cls(d["lo"], d["hi"], d["bins_per_decade"])
        h.count, h.sum = int(d["count"]), float(d["sum"])
        h.min = d["min"] if d["min"] is None else float(d["min"])
        h.max = d["max"] if d["max"] is None else float(d["max"])
        for i, c in d["bins"].items():
            h._counts[int(i)] = int(c)
        return h


@dataclasses.dataclass
class StepEvent:
    """One engine step, structured: timing, phase mix, counter deltas
    and the ledger-byte delta the step (plus any between-step admission
    / reservation charges since the previous event) moved."""

    step: int                       # 0-based step index
    t_start: float                  # stream-relative seconds
    t_end: float
    occupancy: int                  # active slots during the step
    compiles: int                   # kernel libraries built/loaded this step
    counters: Dict[str, float]      # per-step DELTAS of GenStats/sched
    gauges: Dict[str, float]        # point-in-time values (resident, ...)
    # Per-slot phase mix: (slot, rid, phase, fed_tokens, emitted_tokens)
    # where phase is "prefill" | "decode" | "verify" (speculating).
    slots: List[Tuple[int, int, str, int, int]]
    ledger_delta: Dict[CellKey, float]
    draft_delta: Optional[Dict[CellKey, float]] = None
    load_s: float = 0.0             # modeled DMA time of this delta

    @property
    def wall_s(self) -> float:
        """Measured step wall time (host-sync inclusive) — the EXEC side
        of the per-step LOAD-vs-EXEC attribution."""
        return self.t_end - self.t_start

    @property
    def load_share(self) -> float:
        """Modeled-LOAD fraction of the step: load / (load + exec)."""
        tot = self.load_s + self.wall_s
        return self.load_s / tot if tot > 0 else 0.0

    @property
    def bound(self) -> str:
        """"transfer" when the modeled DMA time dominates the measured
        step time, else "compute" — the per-step §V.A attribution."""
        return "transfer" if self.load_share >= 0.5 else "compute"

    def to_json_dict(self) -> Dict:
        """The JSONL ``step`` event for this step."""
        d = {"event": "step", "step": self.step,
             "t_start": self.t_start, "t_end": self.t_end,
             "wall_s": self.wall_s, "occupancy": self.occupancy,
             "compiles": self.compiles, "counters": self.counters,
             "gauges": self.gauges,
             "slots": [list(s) for s in self.slots],
             "ledger_delta": {_cell_str(k): v
                              for k, v in self.ledger_delta.items()},
             "load_s": self.load_s, "bound": self.bound}
        if self.draft_delta is not None:
            d["draft_delta"] = {_cell_str(k): v
                                for k, v in self.draft_delta.items()}
        return d


@dataclasses.dataclass
class BottleneckReport:
    """Transfer-bound vs compute-bound attribution over a timeline.

    Per step: the modeled DMA time of the step's ledger delta
    (``TransferModel`` — the same LOAD model behind
    ``TransferLedger.load_seconds``) against the measured step wall
    time. Aggregates reproduce the bench's LOAD-vs-EXEC report from the
    live series: ``phase_load_s`` is computed from the summed deltas at
    phase granularity with one coalesced transaction per phase, so it
    equals ``ledger.load_seconds()`` on the same cells, and
    ``phase_exec_s`` follows GenStats' pro-rata phase split."""

    steps: int
    transfer_bound: int             # steps with load_share >= 0.5
    compute_bound: int
    load_s: float                   # sum of per-step modeled DMA time
    exec_s: float                   # sum of measured step wall time
    phase_load_s: Dict[str, float]
    phase_exec_s: Dict[str, float]
    dp: int = 1
    tp: int = 1
    per_device_load_s: float = 0.0  # one device's share of the DMA time

    @classmethod
    def from_timeline(cls, timeline: "StepTimeline",
                      ledger: TransferLedger) -> "BottleneckReport":
        """Attribute every step of ``timeline`` and aggregate."""
        tm = timeline.transfer_model
        tb = load = ex = 0.0
        tb = 0
        phase_h2d = {p: 0.0 for p in PHASES}
        phase_d2h = {p: 0.0 for p in PHASES}
        phase_exec = {p: 0.0 for p in PHASES}
        dev_h2d = dev_d2h = 0.0
        for ev in timeline.events:
            load += ev.load_s
            ex += ev.wall_s
            if ev.bound == "transfer":
                tb += 1
            pre = ev.counters.get("prefill_tokens", 0)
            dec = ev.counters.get("decode_tokens", 0)
            frac = pre / max(pre + dec, 1)
            phase_exec["prefill"] += ev.wall_s * frac
            phase_exec["decode"] += ev.wall_s * (1.0 - frac)
            for (p, c, d), b in ev.ledger_delta.items():
                if d == H2D:
                    phase_h2d[p] += b
                    dev_h2d += b * ledger.device_share(c)
                elif d == D2H:
                    phase_d2h[p] += b
                    dev_d2h += b * ledger.device_share(c)
        phase_load = {p: tm.load_time([phase_h2d[p]], True)
                      + tm.drain_time(phase_d2h[p], True)
                      if (phase_h2d[p] or phase_d2h[p]) else 0.0
                      for p in PHASES}
        return cls(steps=len(timeline.events), transfer_bound=tb,
                   compute_bound=len(timeline.events) - tb,
                   load_s=load, exec_s=ex, phase_load_s=phase_load,
                   phase_exec_s=phase_exec, dp=ledger.dp, tp=ledger.tp,
                   per_device_load_s=(
                       tm.load_time([dev_h2d], True)
                       + tm.drain_time(dev_d2h, True)
                       if (dev_h2d or dev_d2h) else 0.0))

    @property
    def load_share(self) -> float:
        """Aggregate modeled-LOAD fraction: load / (load + exec)."""
        tot = self.load_s + self.exec_s
        return self.load_s / tot if tot > 0 else 0.0

    def to_dict(self) -> Dict:
        """JSON-ready summary (what the JSONL ``summary`` line embeds)."""
        return {"steps": self.steps,
                "transfer_bound": self.transfer_bound,
                "compute_bound": self.compute_bound,
                "load_s": self.load_s, "exec_s": self.exec_s,
                "load_share": self.load_share,
                "phase_load_s": self.phase_load_s,
                "phase_exec_s": self.phase_exec_s,
                "dp": self.dp, "tp": self.tp,
                "per_device_load_s": self.per_device_load_s}

    def lines(self) -> List[str]:
        """Human-readable attribution lines for the serve report."""
        out = [f"bottleneck: {self.transfer_bound}/{self.steps} steps "
               f"transfer-bound | modeled LOAD {self.load_s*1e3:.2f} ms "
               f"vs measured EXEC {self.exec_s*1e3:.2f} ms "
               f"(LOAD share {self.load_share*100:.1f}%)"]
        if self.dp * self.tp > 1:
            out.append(
                f"bottleneck per-device (dp={self.dp} tp={self.tp}): "
                f"modeled LOAD {self.per_device_load_s*1e3:.2f} ms "
                f"({self.per_device_load_s / self.load_s:.3f}x "
                f"aggregate)" if self.load_s else
                "bottleneck per-device: no transfer recorded")
        return out


class StepTimeline:
    """Structured per-step event recorder for one serve() run.

    Attaches a charge *tap* to the run's ``TransferLedger`` (and the
    draft proposer's account, when present): every byte charged anywhere
    in the runtime — step chunks, shared weight streams, admission-time
    cache growth, preemption-path table uploads, rollback, prefix-hit
    accounting — is accumulated into the current step's delta AND a
    running total built from the identical sequence of additions, so
    ``ledger_delta_totals()`` equals ``ledger.breakdown()`` bit-exactly
    at any point (the closure guarantee; see docs/observability.md).

    The engine drives it with ``record_step`` after every unified step;
    the scheduler reports admissions/preemptions via ``on_admit`` /
    ``on_preempt``; token emission lands in ``on_token`` / ``on_done``.
    Everything is plain host-side Python on small dicts — no device
    interaction, no synchronisation, no kernel launch.
    """

    #: Histogram metric names tracked by every timeline.
    HIST_NAMES = ("ttft_s", "itl_s", "queue_wait_s", "request_latency_s",
                  "step_wall_s")

    def __init__(self, ledger: TransferLedger, *,
                 draft_ledger: Optional[TransferLedger] = None,
                 transfer_model: Optional[TransferModel] = None,
                 meta: Optional[Dict] = None):
        self.ledger = ledger
        self.draft_ledger = draft_ledger
        self.transfer_model = transfer_model or TransferModel()
        self.meta = dict(meta or {})
        self.events: List[StepEvent] = []
        self.admissions: List[Tuple[int, float, float]] = []
        self.preemptions: List[Tuple[int, float]] = []
        self._spans: List[tuple] = []      # Span fields, as closed
        self.hists: Dict[str, LogHistogram] = {
            n: LogHistogram() for n in self.HIST_NAMES}
        self._now = 0.0
        self._last_token_t: Dict[int, float] = {}
        self._prev_counters: Dict[str, float] = {}
        self._step_delta: Dict[CellKey, float] = {}
        self._cum: Dict[CellKey, float] = {}
        self._draft_step_delta: Dict[CellKey, float] = {}
        self._draft_cum: Dict[CellKey, float] = {}
        self._finalized = False
        ledger.attach_tap(self._tap)
        if draft_ledger is not None:
            draft_ledger.attach_tap(self._draft_tap)

    # -- ledger taps -----------------------------------------------------
    def _tap(self, phase: str, cat: str, direction: str,
             nbytes: float) -> None:
        k = (phase, cat, direction)
        self._step_delta[k] = self._step_delta.get(k, 0.0) + nbytes
        self._cum[k] = self._cum.get(k, 0.0) + nbytes

    def _draft_tap(self, phase: str, cat: str, direction: str,
                   nbytes: float) -> None:
        k = (phase, cat, direction)
        self._draft_step_delta[k] = \
            self._draft_step_delta.get(k, 0.0) + nbytes
        self._draft_cum[k] = self._draft_cum.get(k, 0.0) + nbytes

    # -- scheduler / engine hooks ----------------------------------------
    def on_admit(self, rid: int, t: float, queue_wait_s: float) -> None:
        """One admission: record the queue-age sample and the event."""
        self.admissions.append((rid, t, queue_wait_s))
        self.hists["queue_wait_s"].record(queue_wait_s)
        self._now = max(self._now, t)

    def on_preempt(self, rid: int) -> None:
        """One preempt-to-queue event (stamped at the current stream
        time — preemption happens between steps)."""
        self.preemptions.append((rid, self._now))

    def on_token(self, rid: int, t: float,
                 ttft_s: Optional[float] = None) -> None:
        """One committed token: first tokens carry their TTFT; later
        ones record the inter-token gap (0 for extra tokens accepted
        within one speculative verify step — that is the point)."""
        if ttft_s is not None:
            self.hists["ttft_s"].record(ttft_s)
        else:
            last = self._last_token_t.get(rid)
            if last is not None:
                self.hists["itl_s"].record(t - last)
        self._last_token_t[rid] = t

    def on_done(self, rid: int, latency_s: float) -> None:
        """A request finished: record its end-to-end latency."""
        self.hists["request_latency_s"].record(latency_s)
        self._last_token_t.pop(rid, None)

    def record_span(self, name: str, step: int, parent: Optional[str],
                    t_start_ns: int, t_end_ns: int,
                    rids: Tuple[int, ...] = ()) -> None:
        """One closed engine span, the fields of ``Span`` (kept as a plain
        tuple: the engine calls this ~10 times a step)."""
        self._spans.append((name, step, parent, t_start_ns, t_end_ns, rids))

    @property
    def spans(self) -> List[Span]:
        """The engine's spans, in the order they closed."""
        return [Span._make(s) for s in self._spans]

    def record_step(self, *, t_start: float, t_end: float, occupancy: int,
                    compiles: int, counters: Dict[str, float],
                    gauges: Dict[str, float],
                    slots: List[Tuple[int, int, str, int, int]]) -> None:
        """Close out one engine step. ``counters`` are *cumulative*
        run-relative values (GenStats/scheduler tallies); the timeline
        diffs them against the previous step so every event carries
        per-step deltas that sum back to the run totals. The pending
        ledger tap deltas (charges since the previous event, including
        between-step admission/reservation charges) become the event's
        ``ledger_delta``."""
        delta = {k: counters[k] - self._prev_counters.get(k, 0)
                 for k in counters}
        self._prev_counters = dict(counters)
        led = self._step_delta
        self._step_delta = {}
        h2d = sum(b for (_, _, d), b in led.items() if d == H2D)
        d2h = sum(b for (_, _, d), b in led.items() if d == D2H)
        tm = self.transfer_model
        load = (tm.load_time([h2d], True) if h2d else 0.0) \
            + (tm.drain_time(d2h, True) if d2h else 0.0)
        draft = None
        if self.draft_ledger is not None:
            draft = self._draft_step_delta
            self._draft_step_delta = {}
        ev = StepEvent(step=len(self.events), t_start=t_start,
                       t_end=t_end, occupancy=occupancy,
                       compiles=compiles, counters=delta, gauges=gauges,
                       slots=slots, ledger_delta=led, draft_delta=draft,
                       load_s=load)
        self.events.append(ev)
        self.hists["step_wall_s"].record(ev.wall_s)
        self._now = max(self._now, t_end)

    def finalize(self, t_end: float) -> None:
        """End of run: detach the ledger taps and fold any charges that
        landed after the last step (normally none — the serve loop only
        charges between a step and the next) into a zero-duration flush
        event, so the closure guarantee covers the whole run."""
        if self._finalized:
            return
        self._finalized = True
        self.ledger.detach_tap()
        if self.draft_ledger is not None:
            self.draft_ledger.detach_tap()
        if self._step_delta or self._draft_step_delta:
            self.record_step(t_start=t_end, t_end=t_end, occupancy=0,
                             compiles=0, counters=self._prev_counters,
                             gauges={}, slots=[])
        self._now = max(self._now, t_end)

    # -- views -----------------------------------------------------------
    def ledger_delta_totals(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """The timeline's accumulated cells, nested like
        ``TransferLedger.breakdown()``. Built from the identical
        per-charge addition sequence as the ledger's own cells, so it
        equals ``breakdown()`` bit-exactly — the closure invariant
        asserted in tests and in-bench."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (p, c, d), b in self._cum.items():
            out.setdefault(p, {}).setdefault(c, {})[d] = b
        return out

    def percentile_summary(self, qs: Sequence[float] = (50, 90, 99)
                           ) -> Dict[str, Dict[str, float]]:
        """{metric: {"p50": ..., ...}} over every tracked histogram."""
        return {n: h.percentiles(qs) for n, h in self.hists.items()}

    def bottleneck_report(self) -> BottleneckReport:
        """Per-step LOAD-vs-EXEC attribution over the recorded events."""
        return BottleneckReport.from_timeline(self, self.ledger)

    # -- exporters -------------------------------------------------------
    def write_metrics_jsonl(self, path: str) -> None:
        """Write the JSONL metrics sink: meta header, admit/preempt and
        step events in time order, and a final summary line with the
        histograms, percentiles, bottleneck attribution and the
        accumulated ledger totals."""
        with open(path, "w") as f:
            meta = {"event": "meta", "version": 1, "ts_unit": "s",
                    **self.meta}
            f.write(json.dumps(meta) + "\n")
            for rid, t, wait in self.admissions:
                f.write(json.dumps({"event": "admit", "rid": rid, "t": t,
                                    "queue_wait_s": wait}) + "\n")
            for rid, t in self.preemptions:
                f.write(json.dumps({"event": "preempt", "rid": rid,
                                    "t": t}) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev.to_json_dict()) + "\n")
            summary = {
                "event": "summary", "steps": len(self.events),
                "histograms": {n: h.to_dict()
                               for n, h in self.hists.items()},
                "percentiles": self.percentile_summary(),
                "bottleneck": self.bottleneck_report().to_dict(),
                "ledger_total": {
                    _cell_str(k): v for k, v in self._cum.items()},
            }
            f.write(json.dumps(summary) + "\n")

    def chrome_trace_events(self) -> List[Dict]:
        """The Chrome-trace ``traceEvents`` list: per-slot span tracks
        (phase-named complete events), an engine step track (with the
        engine's spans, where it recorded them: its phases inside each
        step, its waits between), instant events for
        admissions/preemptions, and ledger-byte counter tracks
        (cumulative h2d/d2h MB per category), sorted by ts."""
        US = 1e6
        evs: List[Dict] = []
        pid = 1
        evs.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": "serving-engine"}})
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": 0, "args": {"name": "engine steps"}})
        seen_slots = sorted({s[0] for ev in self.events
                             for s in ev.slots})
        for slot in seen_slots:
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": slot + 1,
                        "args": {"name": f"slot {slot}"}})
        cum_h2d: Dict[str, float] = {}
        cum_d2h: Dict[str, float] = {}
        # With the engine's spans, each step's event spans its whole
        # engine.step, so that the phases nest inside it on the track.
        spans = self.spans
        outer = {sp.step: (sp.t_start_ns / 1e3,
                           max((sp.t_end_ns - sp.t_start_ns) / 1e3, 1.0))
                 for sp in spans if sp.name == "engine.step"}
        for ev in self.events:
            ts, dur = ev.t_start * US, max(ev.wall_s * US, 1.0)
            step_ts, step_dur = outer.get(ev.step, (ts, dur))
            evs.append({"ph": "X", "name": f"step {ev.step}",
                        "cat": "step", "ts": step_ts, "dur": step_dur,
                        "pid": pid, "tid": 0,
                        "args": {"occupancy": ev.occupancy,
                                 "bound": ev.bound,
                                 "load_ms": ev.load_s * 1e3,
                                 "compiles": ev.compiles}})
            for slot, rid, phase, fed, emitted in ev.slots:
                evs.append({"ph": "X", "name": phase, "cat": "slot",
                            "ts": ts, "dur": dur, "pid": pid,
                            "tid": slot + 1,
                            "args": {"rid": rid, "fed": fed,
                                     "emitted": emitted}})
            for (p, c, d), b in sorted(ev.ledger_delta.items()):
                tgt = cum_h2d if d == H2D else cum_d2h if d == D2H \
                    else None
                if tgt is not None:
                    tgt[c] = tgt.get(c, 0.0) + b
            te = ev.t_end * US
            evs.append({"ph": "C", "name": "ledger h2d MB", "pid": pid,
                        "tid": 0, "ts": te,
                        "args": {c: v / 1e6
                                 for c, v in sorted(cum_h2d.items())}})
            evs.append({"ph": "C", "name": "ledger d2h MB", "pid": pid,
                        "tid": 0, "ts": te,
                        "args": {c: v / 1e6
                                 for c, v in sorted(cum_d2h.items())}})
            if "resident_bytes" in ev.gauges:
                evs.append({"ph": "C", "name": "kv resident MB",
                            "pid": pid, "tid": 0, "ts": te,
                            "args": {"resident":
                                     ev.gauges["resident_bytes"] / 1e6}})
        for sp in spans:
            if sp.name == "engine.step":
                continue
            args = {"step": sp.step}
            if sp.rids:
                args["rids"] = list(sp.rids)
            evs.append({"ph": "X", "name": sp.name, "cat": "phase",
                        "ts": sp.t_start_ns / 1e3,
                        "dur": max((sp.t_end_ns - sp.t_start_ns) / 1e3,
                                   1e-3),
                        "pid": pid, "tid": 0, "args": args})
        for rid, t, wait in self.admissions:
            evs.append({"ph": "i", "name": f"admit rid={rid}", "s": "p",
                        "ts": t * US, "pid": pid, "tid": 0,
                        "args": {"queue_wait_ms": wait * 1e3}})
        for rid, t in self.preemptions:
            evs.append({"ph": "i", "name": f"preempt rid={rid}",
                        "s": "p", "ts": t * US, "pid": pid, "tid": 0,
                        "args": {}})
        evs.sort(key=lambda e: (e.get("ts", -1.0), e.get("ph") != "M"))
        return evs

    def write_chrome_trace(self, path: str) -> None:
        """Write the Perfetto-loadable Chrome trace JSON (open at
        https://ui.perfetto.dev or chrome://tracing)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_trace_events(),
                       "displayTimeUnit": "ms",
                       "metadata": self.meta}, f)


# ---------------------------------------------------------------------------
# Validation (CI schema gate + tests)
# ---------------------------------------------------------------------------
def validate_metrics_jsonl(path: str) -> int:
    """Validate a JSONL metrics file against ``METRICS_SCHEMA``.

    Checks: every line parses as a JSON object with a known ``event``
    type carrying that type's required keys; exactly one leading meta
    and one trailing summary line; step indices dense from 0 with
    monotone non-decreasing ``t_start``. Returns the number of step
    events; raises ``ValueError`` on any violation.
    """
    steps = 0
    last_t = -math.inf
    lines = []
    with open(path) as f:
        for i, raw in enumerate(f):
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            if not isinstance(obj, dict) or "event" not in obj:
                raise ValueError(f"{path}:{i + 1}: missing 'event' key")
            kind = obj["event"]
            if kind not in METRICS_SCHEMA:
                raise ValueError(f"{path}:{i + 1}: unknown event "
                                 f"{kind!r}")
            missing = [k for k in METRICS_SCHEMA[kind] if k not in obj]
            if missing:
                raise ValueError(f"{path}:{i + 1}: {kind} event missing "
                                 f"keys {missing}")
            if kind == "step":
                if obj["step"] != steps:
                    raise ValueError(
                        f"{path}:{i + 1}: step index {obj['step']} != "
                        f"expected {steps} (must be dense from 0)")
                if obj["t_start"] < last_t:
                    raise ValueError(f"{path}:{i + 1}: t_start moved "
                                     "backwards")
                last_t = obj["t_start"]
                steps += 1
            lines.append(kind)
    if not lines or lines[0] != "meta":
        raise ValueError(f"{path}: first line must be the meta event")
    if lines[-1] != "summary":
        raise ValueError(f"{path}: last line must be the summary event")
    if lines.count("meta") != 1 or lines.count("summary") != 1:
        raise ValueError(f"{path}: exactly one meta and one summary "
                         "line required")
    return steps


def validate_chrome_trace(path: str) -> int:
    """Validate a Chrome-trace/Perfetto JSON export.

    Checks: the file parses, carries a ``traceEvents`` list, every span
    ("X") event has numeric ``ts``/``dur`` and a ``pid``/``tid``/
    ``name``, counter ("C") events carry numeric args, and ``ts`` is
    monotone non-decreasing across the sorted stream. Returns the span
    count; raises ``ValueError`` on violations.
    """
    with open(path) as f:
        data = json.load(f)
    evs = data.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError(f"{path}: no traceEvents list")
    spans = 0
    last_ts = -math.inf
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph is None:
            raise ValueError(f"{path}: event {i} missing 'ph'")
        ts = e.get("ts")
        if ph != "M":
            if not isinstance(ts, (int, float)):
                raise ValueError(f"{path}: event {i} ({ph}) missing "
                                 "numeric 'ts'")
            if ts < last_ts:
                raise ValueError(f"{path}: event {i} ts moved backwards "
                                 f"({ts} < {last_ts})")
            last_ts = ts
        if ph == "X":
            spans += 1
            for k in ("dur", "pid", "tid", "name"):
                if k not in e:
                    raise ValueError(f"{path}: span event {i} missing "
                                     f"{k!r}")
            if not isinstance(e["dur"], (int, float)) or e["dur"] <= 0:
                raise ValueError(f"{path}: span event {i} has non-"
                                 "positive dur")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"{path}: counter event {i} needs "
                                 "numeric args")
    if spans == 0:
        raise ValueError(f"{path}: no span events")
    return spans


# ---------------------------------------------------------------------------
# The one serve-report formatter (serve.py + benches)
# ---------------------------------------------------------------------------
def serve_report_lines(engine, report,
                       total_requests: Optional[int] = None,
                       launches: Optional[Dict[str, int]] = None
                       ) -> List[str]:
    """Every report line for a finished serve run, from ONE place.

    The JAX package's lines — scheduler/occupancy, paged-arena,
    prefix-cache, speculative (with the draft account), timing,
    latency-percentile (telemetry histograms when available,
    finished-sequence lists otherwise), ledger LOAD-vs-EXEC and
    bottleneck attribution — plus the port's step-time percentiles, its
    paged KV read counter, the mean phase times of a step (where the
    step events carry ``TIMING_COUNTERS``) and, when ``launches``
    ({kernel: launches} of the run) is given, the kernels' launch
    counts — under a serving mesh
    a list of one such dict per rank, a line each. Under a mesh the JAX
    package's mesh line (per-device bytes/token, weight stream and paged
    reads) follows, headed by the mesh (backend, devices) and ending in
    its collectives a step and bytes a rank. ``total_requests``
    defaults to the finished-sequence count (a serve run drains its
    stream)."""
    st = report.stats
    sched = report.sched
    total = total_requests if total_requests is not None \
        else len(report.sequences)
    lines = [
        f"completed {sched.completed}/{total} | "
        f"slot reuses {sched.slot_reuses} | "
        f"mean occupancy {sched.mean_occupancy:.2f}/{engine.num_slots} "
        f"(max {sched.max_occupancy}) | "
        f"step compiles {report.step_compiles}",
        f"chunk scheduling: {sched.prefill_chunks} prompt chunks | "
        f"{sched.deferred_feeds} budget-deferred feeds | "
        f"{st.prefill_tokens} prompt tokens streamed | mean queue wait "
        f"{sched.mean_queue_wait * 1e3:.1f} ms",
    ]
    if engine.paged:
        lines.append(
            f"paged arena: block reissues "
            f"{engine.arena.allocator.reissues} | preemptions "
            f"{sched.preemptions} | resident/token "
            f"{st.resident_bytes_per_token:.0f} B | peak resident "
            f"{st.peak_resident_bytes / 1e6:.2f} MB")
    if engine.prefix_cache:
        pc = engine.arena.prefix_cache
        lines.append(
            f"prefix cache: {st.prefix_hits}/{sched.admitted} "
            f"admissions hit | {st.prefix_hit_tokens} prompt tokens "
            f"from shared pages | {st.cow_splits} CoW splits | "
            f"{len(pc)} cached chains ({pc.evictions} evicted)")
    if engine.spec != "off":
        lines.append(
            f"speculative[{engine.spec} k={engine.spec_k}]: "
            f"accept {st.spec_accepted}/{st.spec_proposed} "
            f"({st.spec_accept_rate * 100:.0f}%) | rolled back "
            f"{st.spec_rolled_back} tok | steps/token "
            f"{st.steps_per_token:.3f} | weight-stream/token "
            f"{st.transfers.weight_stream_bytes_per_token / 1e6:.3f} MB"
            f" | lanes trimmed {sched.spec_lanes_trimmed}")
        if st.draft_transfers is not None:
            prop = engine._proposer
            lines.append(
                f"draft account: "
                f"{st.draft_transfers.bytes_per_token / 1e6:.3f}"
                f" MB/proposal ({prop.steps} draft steps, {prop.passes} "
                "draft passes)")
    lines.append(
        f"prefill {st.prefill_s * 1e3:.1f} ms ({st.prefill_tokens} tok)"
        f" | decode {st.decode_s * 1e3:.1f} ms ({st.decode_tokens} tok, "
        f"{st.decode_tok_per_s:.1f} tok/s) | "
        f"throughput {report.throughput_tok_s:.1f} tok/s | "
        f"arena {st.cache_bytes / 1e6:.1f} MB")
    lines.append(
        f"steps {st.steps} | p50 step {report.step_ms_percentile(50):.2f} ms"
        f" p90 step {report.step_ms_percentile(90):.2f} ms | paged KV "
        f"reads {st.paged_kv_read_bytes / 1e6:.1f} MB")
    tl = report.timeline
    if tl is not None and tl.events \
            and TIMING_COUNTERS[0] in tl.events[0].counters:
        ms = {k: sum(ev.counters[k] for ev in tl.events)
              / max(st.steps, 1) * 1e3 for k in TIMING_COUNTERS}
        between = sum(ms[k] for k in ("host_reserve_s", "host_admit_s",
                                      "host_plan_s", "host_upload_s",
                                      "host_commit_s"))
        lines.append(
            f"host phases a step: between steps {between:.2f} ms (reserve, "
            f"admit, plan, upload, commit) | model call "
            f"{ms['model_call_s']:.2f} ms | sample {ms['sample_s']:.2f} ms"
            f" | read-back {ms['readback_s']:.2f} ms")
    if tl is not None and tl.hists["request_latency_s"].count:
        pct = tl.hists["request_latency_s"].percentiles((50, 90, 99))
        tp = tl.hists["ttft_s"].percentiles((50, 99))
        lines.append(
            f"latency p50 {pct['p50'] * 1e3:.0f} ms | p90 "
            f"{pct['p90'] * 1e3:.0f} ms | p99 {pct['p99'] * 1e3:.0f} ms"
            f" | ttft p50 {tp['p50'] * 1e3:.0f} ms p99 "
            f"{tp['p99'] * 1e3:.0f} ms (streaming estimators)")
    else:
        pct = report.latency_percentiles((50, 90, 99))
        lines.append(
            f"latency p50 {pct[50] * 1e3:.0f} ms | p90 "
            f"{pct[90] * 1e3:.0f} ms | p99 {pct[99] * 1e3:.0f} ms")
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        tr = st.transfers
        col = report.collectives or {}
        steps = max(st.steps, 1)
        line = (f"{mesh.describe()}: per-device bytes/token "
                f"{tr.per_device_bytes_per_token / 1e6:.3f} MB | "
                f"per-device weight-stream/token "
                f"{tr.per_device_weight_stream_bytes_per_token / 1e6:.3f}"
                " MB")
        if engine.paged:
            line += (f" | per-device paged-read/token "
                     f"{st.paged_kv_read_bytes_per_device / max(st.decode_tokens, 1) / 1e6:.3f} MB")
        line += (f" | collectives {col.get('collectives', 0) / steps:.1f}"
                 f"/step ({col.get('bytes', 0) / steps / 1e6:.3f} MB/step "
                 f"a rank, {col.get('staged', 0)} staged through host)")
        if getattr(engine, "plan_note", None):
            line += (f" | MLA split not shard-invariant: {engine.plan_note} "
                     "(tokens one device's up to near-ties)")
        lines.append(line)
    lines.append("transfer ledger (host<->device):")
    exec_s = {"prefill": st.prefill_s, "decode": st.decode_s}
    lines.extend(f"  {ln}"
                 for ln in report.ledger.summary_lines(exec_s))
    if tl is not None:
        lines.extend(tl.bottleneck_report().lines())
    if isinstance(launches, dict):
        launches = [launches]
    for r, counts in enumerate(launches or ()):
        head = "kernels" if len(launches) == 1 else f"kernels (rank {r})"
        lines.append(f"{head}: " + " | ".join(
            f"{name} launches {n}" for name, n in counts.items()))
    return lines


def _main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m repro_torch.runtime.telemetry validate FILE...``
    — schema-validate ``.jsonl`` metrics and ``.json`` trace exports."""
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.runtime.telemetry")
    ap.add_argument("command", choices=["validate"])
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    for path in args.files:
        if path.endswith(".jsonl"):
            n = validate_metrics_jsonl(path)
            print(f"{path}: valid metrics JSONL ({n} step events)")
        else:
            n = validate_chrome_trace(path)
            print(f"{path}: valid Perfetto/Chrome trace ({n} spans)")
    return 0


if __name__ == "__main__":                         # pragma: no cover
    raise SystemExit(_main())
