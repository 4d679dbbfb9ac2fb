"""idle_in_model_pct: device-idle time inside the engine's engine.model
spans (the device waiting on the host's launches), as a share of the
traced sub-window."""
from portbench.core import spans


def read(ctx):
    return spans.idle_pct(ctx, 1)
