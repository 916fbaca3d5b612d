"""The share of the profiled call in which no device event ran (the union
of the trace's device intervals), %."""
from portbench.layers import idle_share as read  # noqa: F401
