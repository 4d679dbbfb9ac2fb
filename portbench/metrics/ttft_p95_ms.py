"""ttft_p95_ms: the 95th percentile, over every request due in the
window, of its first token's time minus its due time (host clock)."""
from portbench.core.readers import due_in_window
from portbench.core.schedule import percentile


def read(ctx):
    v = [(s.t_first_token - s.req.arrival_s) * 1e3
         for s in due_in_window(ctx) if s.t_first_token is not None]
    return percentile(v, 95) if v else None
