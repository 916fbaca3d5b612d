"""The 90th percentile of the seconds from each request's sending until its
image resolved, over every request sent in the window."""
import math

from portbench.windows import latencies, percentile


def read(run):
    p = percentile(latencies(run.records), 0.9)
    return None if p is None or math.isinf(p) else p
