"""matmul_q8_0_roofline: B2, the q8_0 matmul kernel. Every call of a
step from the configuration's shapes at M = slots x chunk rows (the rows
the kernel is given), each call's bound summed over the traced steps,
over the device time of the kernel (``dequant_matmul`` kernels)."""
from portbench.core import work
from portbench.core.readers import share, traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    if not steps:
        return None
    m = ctx.slots * ctx.chunk
    per_step = sum(work.q8_0_matmul(m, n, k).bound_s
                   for n, k in ctx.adapter.matmul_shapes(ctx.hf))
    return share(per_step * len(steps),
                 ctx.trace.device_s(lambda n: "dequant_matmul" in n))
