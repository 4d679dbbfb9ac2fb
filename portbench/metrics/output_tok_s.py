"""output_tok_s: generated tokens committed by the steps that ended in
the window, over the window's length (host clock)."""
from portbench.core.readers import window_steps


def read(ctx):
    w0, w1 = ctx.window
    steps = window_steps(ctx)
    return sum(s.emitted for s in steps) / (w1 - w0) if steps else None
