"""prefix_hit_pct: prompt tokens served from cached prefix pages, as a
share of the prompt tokens of the requests admitted in the window."""


def read(ctx):
    w0, w1 = ctx.window
    seqs = [s for s in ctx.sequences if w0 <= s.t_admitted < w1]
    total = sum(s.req.prompt_len for s in seqs)
    if not total:
        return None
    hit = sum(ctx.schedule.hit.get(s.rid, 0) for s in seqs)
    return 100.0 * hit / total
