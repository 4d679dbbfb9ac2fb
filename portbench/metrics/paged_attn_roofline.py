"""paged_attn_roofline: the paged attention kernel (B1, GQA) over bf16
pages: each traced step's work from every slot's position and fed
rows, every layer, over the device time of the ``paged_`` kernels."""
from portbench.core.readers import feeds, share, traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    if not steps:
        return None
    bound = sum(ctx.adapter.attention_work(ctx.hf, feeds(s)).bound_s
                for s in steps)
    return share(bound, ctx.trace.device_s(lambda n: "paged_" in n))
