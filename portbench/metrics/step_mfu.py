"""step_mfu: the model's useful flops in the traced steps (fed tokens
only, attention at each token's context, the lm_head on sampled rows)
over the sub-window times the card's bf16 peak."""
from portbench.core import work
from portbench.core.readers import feeds, sampled_rows, traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    if not steps or ctx.trace.window_s <= 0:
        return None
    flops = sum(ctx.adapter.useful_flops(ctx.hf, feeds(s), sampled_rows(s))
                for s in steps)
    return 100.0 * flops / (ctx.trace.window_s * work.PEAK_BF16_FLOPS)
