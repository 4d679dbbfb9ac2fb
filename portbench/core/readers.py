"""Helpers the metric readers share (``portbench/metrics/<name>.py``)."""
from __future__ import annotations

from typing import List, Tuple


def window_steps(ctx):
    """Steps that ended inside the measured window."""
    return ctx.schedule.in_window(*ctx.window)


def due_in_window(ctx):
    """Finished sequences whose request was due inside the window."""
    w0, w1 = ctx.window
    return [s for s in ctx.sequences if w0 <= s.req.arrival_s < w1]


def traced_steps(ctx):
    """Steps inside the profiled sub-window (none without a trace)."""
    if ctx.trace is None or not ctx.trace_steps:
        return []
    return ctx.schedule.by_index(*ctx.trace_steps)


def feeds(step) -> List[Tuple[int, int]]:
    """(pos0, n) of every slot that fed rows in the step."""
    return [(f.pos0, f.n) for f in step.feeds]


def sampled_rows(step) -> int:
    """Rows whose logits the step sampled (one per emitting slot)."""
    return sum(1 for f in step.feeds if f.emitted)


def share(bound_s: float, device_s) -> float:
    """A roofline share in %, or None where the device time is unknown."""
    if not device_s:
        return None
    return 100.0 * bound_s / device_s


def itl_p95_ms(ctx):
    """The 95th percentile of every gap between consecutive output
    tokens of every request, both tokens inside the window (a token's
    time is the end of the step that committed it)."""
    from portbench.core.schedule import percentile
    g = ctx.schedule.gaps_in_window(*ctx.window)
    return percentile(g * 1e3, 95) if g.size else None


def step_ms(ctx):
    """The window's length over the engine steps that ended in it."""
    w0, w1 = ctx.window
    steps = window_steps(ctx)
    return 1e3 * (w1 - w0) / len(steps) if steps else None
