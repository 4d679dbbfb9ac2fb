"""What the engine's own spans and phase counters say.

The port's serving engine (``runtime/engine.py``, with telemetry on) names
its serve loop from inside: ``engine.step`` around each iteration that
steps, its phases (``engine.reserve``, ``engine.admit``, ``engine.plan``,
``engine.upload``, ``engine.model``, ``engine.sample``,
``engine.readback``, ``engine.commit``) and ``engine.wait``. Each is a
plain host op in the device trace, on the profiler's clock; each step
event carries the phases' seconds as counters. The readers here return
None where the program records neither, as a program before them does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.core.readers import window_steps
from portbench.core.trace import _union

# The step's host work between model calls, and the model call itself
# (the program's TIMING_COUNTERS, by name).
BETWEEN_STEPS = ("host_reserve_s", "host_admit_s", "host_plan_s",
                 "host_upload_s", "host_commit_s")
MODEL_CALL = ("model_call_s",)

Intervals = List[Tuple[int, int]]


def untraced_window_steps(ctx):
    """Steps that ended in the window, less those the profiler traced
    (its recording inflates the host's time there)."""
    lo, hi = ctx.trace_steps or (0, 0)
    return [s for s in window_steps(ctx) if not lo <= s.index < hi]


def phase_ms(ctx, keys) -> Optional[float]:
    """The mean, over ``untraced_window_steps``, of the sum of the step's
    phase counters ``keys``, in ms."""
    steps = untraced_window_steps(ctx)
    if not steps or any(k not in s.counters for s in steps for k in keys):
        return None
    return 1e3 * sum(s.counters[k] for s in steps for k in keys) / len(steps)


def overlap_ns(a: Intervals, b: Intervals) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> Intervals:
    """The sub-window's device-idle intervals: the complement, over
    [t0, t1], of the union of the device operations' intervals."""
    out, t = [], trace.t0
    for s, e in _union([(o.start, o.end) for o in trace.ops]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out


def idle_split(trace) -> Optional[Tuple[int, int]]:
    """(device-idle ns inside an ``engine.*`` span and outside every
    ``engine.model`` span, device-idle ns inside ``engine.model`` spans),
    by interval intersection; None without a device operation or an
    engine span in the trace."""
    if trace is None or not trace.ops:
        return None
    engine = [(s, e) for s, e, n in trace.host if n.startswith("engine.")]
    if not engine:
        return None
    model = _union([(s, e) for s, e, n in trace.host if n == "engine.model"])
    gaps = idle(trace)
    in_model = overlap_ns(gaps, model)
    return overlap_ns(gaps, _union(engine)) - in_model, in_model


def idle_pct(ctx, part: int) -> Optional[float]:
    """Part ``part`` of ``idle_split`` as a share of the sub-window, %."""
    split = idle_split(ctx.trace)
    if split is None or ctx.trace.t1 <= ctx.trace.t0:
        return None
    return 100.0 * split[part] / (ctx.trace.t1 - ctx.trace.t0)
