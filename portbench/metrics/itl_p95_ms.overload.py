"""itl_p95_ms.overload: itl_p95_ms in a cell above the knee, where the
queue grows through the run and a tail is a per-layer reading."""
from portbench.core.readers import itl_p95_ms as read  # noqa: F401
