"""device_idle_pct: the share of the traced sub-window in which no device
operation ran (the union of their intervals, not a sum)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
