"""idle_outside_model_pct: device-idle time inside the engine's spans
and outside every engine.model span (the host between model calls), as
a share of the traced sub-window."""
from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx, 0)
