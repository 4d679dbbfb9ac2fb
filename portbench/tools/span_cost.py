"""The cost of the engine's span recorder a step, with the profiler off
and on: the serve loop's calls into ``runtime/engine.py``'s ``_Spans``
for one step (``engine.step``, its eight phases, the admission's rids,
the counters handed to the step's event), with no work between them,
against the same calls into the recorder telemetry-off engines use.
Under the profiler it also counts the device-track events that carry an
``engine.`` name (a span must be a host op only).

    python3 portbench/tools/span_cost.py --steps 2000 --repeats 7

Prints one JSON line: per-step microseconds (medians of the repeats).
Run it on the card's host for the numbers ``PERF.md`` gives.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = (("engine.plan", "host_plan_s"), ("engine.upload", "host_upload_s"),
          ("engine.model", "model_call_s"), ("engine.sample", "sample_s"),
          ("engine.readback", "readback_s"),
          ("engine.commit", "host_commit_s"))


def one_step(sp, counters, admitted, touch) -> None:
    """The recorder's calls of one serve-loop iteration that steps."""
    sp.open_step()
    sp.phase("engine.reserve", "host_reserve_s")
    sp.phase("engine.admit", "host_admit_s")
    sp.close(admitted)
    for name, counter in PHASES:
        sp.phase(name, counter)
        if name == "engine.model" and touch is not None:
            touch()
    sp.close()
    counters.update(getattr(sp, "totals", {}))
    sp.close_step()


def per_step_us(make, steps: int, repeats: int, touch=None) -> float:
    out = []
    for _ in range(repeats):
        sp, counters, admitted = make(), {}, []
        t = time.perf_counter()
        for _ in range(steps):
            one_step(sp, counters, admitted, touch)
        out.append((time.perf_counter() - t) / steps * 1e6)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import engine
    from repro_torch.runtime.telemetry import StepTimeline
    from repro_torch.runtime.transfers import TransferLedger

    cfg = get_config("qwen3-0.6b").reduced()

    def spans():
        tl = StepTimeline(TransferLedger(cfg, "q8_0"))
        return engine._Spans(tl, time.perf_counter_ns())

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        x = torch.ones((1024,), device="cuda")
        touch = lambda: x.add_(1.0)     # noqa: E731
    else:
        touch = None
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "off_us": per_step_us(spans, args.steps, args.repeats),
           "telemetry_off_us": per_step_us(lambda: engine._NO_SPANS,
                                           args.steps, args.repeats)}
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        out["on_us"] = per_step_us(spans, args.steps // 10, args.repeats)
        per_step_us(spans, 50, 1, touch)    # device work inside the spans
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    events = prof.profiler.kineto_results.events()
    ours = [e for e in events if e.name().startswith("engine.")]
    out["host_spans"] = sum(not str(e.device_type()).endswith("CUDA")
                            for e in ours)
    out["device_track_spans"] = len(ours) - out["host_spans"]
    out["user_annotations"] = sum(e.is_user_annotation() for e in ours)
    out["device_ops"] = sum(str(e.device_type()).endswith("CUDA")
                            for e in events)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
