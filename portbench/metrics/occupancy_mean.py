"""occupancy_mean: slots in use, averaged over the steps of the window
(the scheduler's occupancy at each step's end)."""
from portbench.core.readers import window_steps


def read(ctx):
    steps = window_steps(ctx)
    return sum(s.occupancy for s in steps) / len(steps) if steps else None
