"""Where the device idles, by the engine's phases: one traced run of a
cell (``core/bench.py``'s ``run_cell``, as ``run.py --trace 1`` runs it),
then the traced sub-window's device-idle seconds inside each
``engine.*`` phase span (interval intersection, as ``core/spans.py``
measures its two shares), inside ``engine.step`` but no phase, and in no
span; beside them, each phase's host ms a step in the traced steps and
in the window's untraced ones (the profiler's own cost on the host).

    python3 portbench/tools/idle_by_phase.py --workload qwen2-72b.decode \\
        --seed 11 --seconds 51

Prints one JSON line. Run it on the card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

COUNTER = {"engine.reserve": "host_reserve_s", "engine.admit": "host_admit_s",
           "engine.plan": "host_plan_s", "engine.upload": "host_upload_s",
           "engine.model": "model_call_s", "engine.sample": "sample_s",
           "engine.readback": "readback_s", "engine.commit": "host_commit_s"}


def main(argv=None) -> int:
    t_process = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    from portbench.core import bench, spans
    from portbench.core.readers import traced_steps
    from portbench.core.trace import _union

    kept = []

    class Ctx(bench.Ctx):
        """``bench.Ctx``, kept for the trace and steps it holds."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    bench.Ctx = Ctx
    out = bench.run_cell(args.workload, args.seed, args.seconds, True,
                         t_process)
    ctx = kept[0]
    trace = ctx.trace
    if trace is None:
        print("idle_by_phase: no device trace (no CUDA device)",
              file=sys.stderr)
        return 2
    gaps = spans.idle(trace)

    def idle_in(match):
        return spans.overlap_ns(gaps, _union(
            [(s, e) for s, e, n in trace.host if match(n)])) / 1e9
    phases = (*COUNTER, "engine.wait")
    by = {name: idle_in(lambda n: n == name) for name in phases}
    in_engine = idle_in(lambda n: n.startswith("engine."))
    idle_s = sum(e - s for s, e in gaps) / 1e9
    traced = traced_steps(ctx)
    untraced = spans.untraced_window_steps(ctx)

    def ms(steps, key):
        return 1e3 * sum(s.counters.get(key, 0.0) for s in steps) \
            / max(len(steps), 1)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": out["device"], "correct": out["correct"],
        "window_s": trace.window_s, "idle_s": idle_s,
        "idle_s_by_phase": by,
        "idle_s_in_step_between_phases":
            in_engine - idle_in(lambda n: n in phases),
        "idle_s_in_no_span": idle_s - in_engine,
        "host_ms_a_step": {name: {"traced": ms(traced, key),
                                  "untraced": ms(untraced, key)}
                           for name, key in COUNTER.items()},
        "steps": {"traced": len(traced), "untraced": len(untraced)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
