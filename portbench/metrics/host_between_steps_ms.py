"""host_between_steps_ms: the host's work between two model calls, a
step: the engine's reserve, admit, plan, upload and commit phase
counters summed, averaged over the window's steps that the profiler did
not trace."""
from portbench.core import spans


def read(ctx):
    return spans.phase_ms(ctx, spans.BETWEEN_STEPS)
