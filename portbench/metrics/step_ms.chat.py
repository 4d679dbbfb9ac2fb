"""step_ms.chat: the window's length over the engine steps that ended
in it, in the cell below the knee (moves itl_p95_ms)."""
from portbench.core.readers import step_ms as read  # noqa: F401
