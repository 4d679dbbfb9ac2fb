"""model_call_ms: the host's time in the model call a step (its launch
path through the model; the engine's model_call_s counter), averaged
over the window's steps that the profiler did not trace."""
from portbench.core import spans


def read(ctx):
    return spans.phase_ms(ctx, spans.MODEL_CALL)
