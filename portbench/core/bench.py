"""One run of one cell: set-up, the served window, the metrics, the check.

The program under test is ``repro_torch``'s serving engine,
``ServingEngine.serve``, built with the arguments that
``repro_torch.launch.serve.run_stream`` passes. The harness reaches the
program only through public names: ``models.api.build_model``,
``core.convert.quantize_params``, the engine, and the ``ModelAPI`` it
hands the engine, with the model call wrapped (``dataclasses.replace``).

Set-up: CUDA, the seed-made weights on the card, the port's
quantization stage, one short serve of warm-up requests (kernels built
or loaded, every step shape run; for a mix with a document, the
document's pages published). Then the measured serve: arrivals from 0,
a ramp-up of ``ramp_s`` seconds, the window of ``--seconds``, and the
drain of whatever arrived before the window closed (outside the window).
The peak memory is the measured serve's: the peak counter is reset once
set-up is done, so set-up's bf16 weights, freed before the serve, do not
count. After the serve: the metrics, the peak memory, the program's
state freed, the reference's check, and the result line.

A control run (``control``, the calibration tool only) goes through the
same comparison and should come out not correct: ``"q4_0"`` puts the
reference in q4_0, the format below the served q8_0, in the program's
place; ``"int8_pages"`` serves with the program's own int8 pages in
place of the configuration's bf16 pages.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional


from portbench.core import check as checks
from portbench.core import traffic
from portbench.core.schedule import Schedule
from portbench.core.trace import Trace
from portbench.reference import weights

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The device trace covers the window's last seconds (at most half of it).
TRACE_SPAN_S = 4.0
# The port's ``kv_quant`` mode for each page format a configuration states.
KV_QUANT = {"bfloat16": "none", "int8": "int8"}
CONTROLS = ("q4_0", "int8_pages")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: Dict, workload: str) -> Dict:
    """The cell's entry, its configuration (the file's contents plus its
    name), its mix and its cell file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    hf = load_json(ROOT / conf["file"])
    hf["name"] = conf["name"]
    return {"cell": cell, "hf": hf,
            "mix": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "params": load_json(BENCH / "cells" / f"{workload}.json")}


def metric_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {k.split(".")[0] for k, v in list(sys.modules.items())
            if v is not None}
    return sorted(tops & set(FORBIDDEN))


class Instruments:
    """The harness's hooks on the program, armed for the measured serve:
    step calls counted, the profiler started and stopped at step
    boundaries over the window's last seconds, and a span around the
    model call (the last two with ``trace``)."""

    def __init__(self, torch, trace: bool):
        self.torch, self.trace = torch, trace
        self.armed = False
        self.calls = 0
        self.prof = None
        self.prof_steps = None      # (first, end) step indices traced
        self.events = None          # the profiler's events, once stopped
        self.window = None          # (t0, start_at, stop_at), host clock
        self._first = 0

    def wrap(self, model):
        fn = model.decode_step
        rf = self.torch.profiler.record_function

        def decode_step(*a, **kw):
            if self.armed:
                self._profile_edge()
                self.calls += 1
            if self.trace:
                with rf("step.model"):
                    return fn(*a, **kw)
            return fn(*a, **kw)
        return dataclasses.replace(model, decode_step=decode_step)

    def arm(self, t0: float, w1: float, span: float) -> None:
        self.armed, self.calls = True, 0
        self.window = (t0, w1 - span, w1)

    def _profile_edge(self) -> None:
        if not self.trace:
            return
        t0, start_at, stop_at = self.window
        now = time.perf_counter() - t0
        if self.prof is None and self.prof_steps is None \
                and now >= start_at:
            self.torch.cuda.synchronize()
            self.prof = self.torch.profiler.profile(activities=[
                self.torch.profiler.ProfilerActivity.CPU,
                self.torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self._first = self.calls
        elif self.prof is not None and now >= stop_at:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        self.torch.cuda.synchronize()
        self.prof.stop()
        self.prof_steps = (self._first, self.calls)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None

    def disarm(self) -> None:
        self.stop()
        self.armed = False


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads."""

    hf: Dict
    adapter: object
    slots: int
    chunk: int
    window: tuple                   # (w0, w1), seconds from serve start
    schedule: Schedule
    sequences: list
    setup_s: float
    trace: Optional[Trace] = None
    trace_steps: tuple = ()         # (first, end) step indices traced


def engine_kwargs(hf: Dict, mix: Dict) -> Dict:
    """``run_stream``'s engine arguments for this configuration, the
    arena sized so that no request is ever preempted."""
    s = hf["serve"]
    bs = s["block_size"]
    max_seq = -(-traffic.max_len(mix) // bs) * bs
    blocks = s["slots"] * (max_seq // bs) \
        + -(-mix.get("doc_tokens", 0) // bs) + s["slots"] + 1
    return dict(quant=s["quant"], num_slots=s["slots"], max_seq=max_seq,
                chunk_size=s["chunk_size"], block_size=bs, num_blocks=blocks,
                paged_attn="fused", prefix_cache=s["prefix_cache"],
                kv_quant=KV_QUANT[s["kv_pages"]], telemetry=True)


def requests_of(specs, Request, SamplingParams) -> list:
    return [Request(rid=s.rid, tokens=s.tokens,
                    max_new_tokens=s.max_new_tokens,
                    sampling=SamplingParams(temperature=0.0),
                    arrival_s=s.arrival_s) for s in specs]


def setup(workload: str, seed: int, trace: bool, device: str = "cuda",
          bench: Optional[Dict] = None, resolved: Optional[Dict] = None):
    """Set-up: the seed-made weights on the device, the port's
    quantization stage, the engine, the warm-up serve. ``bench``/``resolved``: a benchmark and a cell given directly
    instead of read from the checkout (the CPU tests' tiny cells)."""
    import torch
    from repro_torch.core import convert
    from repro_torch.models.api import build_model
    from repro_torch.runtime.engine import ServingEngine
    from repro_torch.runtime.request import Request, SamplingParams

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    r = resolved or resolve(bench, workload)
    hf, mix = r["hf"], r["mix"]
    adapter = importlib.import_module(f"portbench.models.{hf['model_type']}")
    dev = torch.device(device)
    cfg = adapter.port_config(hf, hf["serve"])
    inst = Instruments(torch, trace and dev.type == "cuda")
    model = inst.wrap(build_model(cfg))
    leaves = adapter.reference.leaves(hf)
    tensors = weights.make_all(leaves, seed, dev)
    dense = adapter.port_params(hf, cfg, tensors)
    del tensors
    qparams = convert.quantize_params(dense, hf["serve"]["quant"])
    del dense
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kw = engine_kwargs(hf, mix)
    engine = ServingEngine(model, qparams, device=dev, **kw)
    engine.serve(requests_of(traffic.warmup(mix, seed, hf["vocab_size"],
                                            kw["num_slots"],
                                            kw["chunk_size"]),
                             Request, SamplingParams), seed=seed)
    if inst.trace:
        warm = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        warm.start()
        torch.ones((8,), device=dev).sum().item()
        warm.stop()
    return types.SimpleNamespace(
        torch=torch, bench=bench, hf=hf, mix=mix, params=r["params"],
        adapter=adapter, dev=dev, cfg=cfg, inst=inst, leaves=leaves,
        kw=kw, engine=engine,
        requests=lambda specs: requests_of(specs, Request, SamplingParams))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             control: Optional[str] = None, bench: Optional[Dict] = None,
             resolved: Optional[Dict] = None) -> Dict:
    """One run of the cell; returns the result line's object.
    ``control``: one of ``CONTROLS`` in the program's place (the
    calibration tool); ``bench``/``resolved``: as ``setup``'s."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; known: {CONTROLS}")
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    resolved = resolved or resolve(bench, workload)
    if control == "int8_pages":
        resolved = dict(resolved, hf=dict(resolved["hf"], serve=dict(
            resolved["hf"]["serve"], kv_pages="int8")))
    su = setup(workload, seed, trace, device, bench, resolved)
    torch, hf, mix, params = su.torch, su.hf, su.mix, su.params
    adapter, dev, inst, kw = su.adapter, su.dev, su.inst, su.kw
    engine, leaves, bench = su.engine, su.leaves, su.bench
    ref = adapter.reference
    requests_of_specs = su.requests
    del su
    specs = traffic.stream(mix, params, seed, seconds, hf["vocab_size"])
    reqs = requests_of_specs(specs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_process
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the measured serve -------------------------------------------------
    w0 = float(params["ramp_s"])
    w1 = w0 + seconds
    t0 = time.perf_counter()
    inst.arm(t0, w1, min(TRACE_SPAN_S, seconds / 2))
    try:
        report = engine.serve(reqs, seed=seed)
    finally:
        inst.disarm()
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    prompt_len = {q.rid: q.prompt_len for q in reqs}
    events = report.timeline.events
    sched = Schedule(events, prompt_len)
    ctx = Ctx(hf, adapter, kw["num_slots"], kw["chunk_size"],
              (w0, w1), sched, report.sequences, setup_s)
    if inst.prof_steps is not None:
        ctx.trace = Trace(inst.events)
        ctx.trace_steps = inst.prof_steps
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[section]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = metric_reader(m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    due = {q.rid for q in reqs if w0 <= q.arrival_s < w1}
    served_in_full = sum(s.rid in due and len(s.generated)
                         == s.req.max_new_tokens for s in report.sequences)
    attempted, failed = len(due), len(due) - served_in_full

    # -- the check, with the program's state freed ---------------------------
    samples = checks.pick(report.sequences, (w0, w1), seed)
    breakdown = None
    if ctx.trace is not None:
        breakdown = {"device_ops": ctx.trace.top_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    busy = (ctx.trace.busy_s, ctx.trace.window_s) if ctx.trace else None
    del engine, report, inst, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    W = weights.WeightSource(leaves, seed, dev)
    fmt = control if control == "q4_0" else None
    got = checks.compare(ref, hf, W, samples, dev, control_fmt=fmt)
    W.release()
    if fmt is not None:
        # The control in the program's place: its gap is the one judged.
        got = {"logit_gap": got["control_logit_gap"],
               "program_logit_gap": got["logit_gap"]}
    q = [(ev.t_end, ev.gauges.get("queue_len", 0.0), ev.occupancy)
         for ev in events if ev.slots]
    at = {w: next(((n, o) for t, n, o in q if t >= w), (None, None))
          for w in (w0, w1)}
    print(f"portbench: queue, occupancy at the window's start {at[w0]}, "
          f"at its end {at[w1]}; {sched.preemptions} preemptions",
          file=sys.stderr)
    print(f"portbench: set-up {setup_s:.1f} s, serve {serve_s:.1f} s "
          f"(window {w0:g}-{w1:g} s, {len(reqs)} requests), check "
          f"{time.perf_counter() - t_check:.1f} s over "
          f"{sum(len(s.served) for s in samples)} served tokens of "
          f"{len(samples)} requests", file=sys.stderr, flush=True)
    limits = params["check"]
    compared = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    correct = bool(samples) and failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": correct, "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if busy is not None:
        out["device"]["busy_s"], out["device"]["window_s"] = busy
        out["breakdown"] = breakdown
    extra = {k: v for k, v in got.items() if k not in compared}
    out["served_checked"] = sum(len(s.served) for s in samples)
    if control is not None:
        out["control"] = control
    if extra:
        out["readings"] = extra
    out["compared"] = compared
    return out
