"""queue_wait_p50_ms: the median, over the requests due in the window,
of admission time minus due time (the scheduler's queue)."""
from portbench.core.readers import due_in_window
from portbench.core.schedule import percentile


def read(ctx):
    v = [(s.t_admitted - s.req.arrival_s) * 1e3 for s in due_in_window(ctx)]
    return percentile(v, 50) if v else None
