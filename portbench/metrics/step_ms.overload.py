"""step_ms.overload: the window's length over the engine steps that
ended in it, in a cell above the knee (moves output_tok_s)."""
from portbench.core.readers import step_ms as read  # noqa: F401
