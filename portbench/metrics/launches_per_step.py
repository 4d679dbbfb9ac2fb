"""launches_per_step: kernel and graph launches the host made in the
traced steps (the profiler's runtime and driver launch calls), per
step."""
from portbench.core.readers import traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    return ctx.trace.launches / len(steps) if steps else None
