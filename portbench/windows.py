"""The window's arithmetic, from the records of a run.

The window opens when the first request is sent, and no request is sent
after ``seconds``; those in flight at the close are waited for. A rate
takes all that work over all that time: the images of every request sent
in the window, over the span from the window's start until the last of
them resolved, so that a stall at the end lengthens the span, and the span
ends where an image did, so that the rate counts whole images. A tail
takes every request sent in the window; a request that failed or never
resolved counts as infinitely late.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple


def all_images(records) -> Tuple[int, Optional[float]]:
    """(images of the requests sent in the window, seconds from the window's
    start until the last request resolved, failed ones included)."""
    done = [r.done for r in records if r.done is not None]
    return sum(r.image is not None for r in records), (max(done) if done else None)


def latencies(records) -> List[float]:
    return [r.done - r.sent if r.image is not None and r.done is not None else math.inf
            for r in records]


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank q-quantile: the smallest value with at least a share
    q of the values at or below it."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]
