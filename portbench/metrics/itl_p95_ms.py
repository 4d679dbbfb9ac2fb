"""itl_p95_ms: the 95th percentile of every gap between consecutive
output tokens of every request, both tokens inside the window (host
clock: a token's time is the end of the step that committed it). The
end-to-end tail below the knee."""
from portbench.core.readers import itl_p95_ms as read  # noqa: F401
