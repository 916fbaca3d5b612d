"""The window's arithmetic: all the work over all the time, and the tail over every request."""
import math

import numpy as np

from portbench import windows
from portbench.loadgen import Record
from portbench.manifest import reader

IMG = np.zeros((2, 2, 3), np.uint8)


def rec(sent, done, ok=True):
    return Record(0, 0, {}, sent, done, IMG if ok else None, None if ok else "failed")


class Run:
    def __init__(self, records, seconds=10.0, setup_s=3.0):
        self.records, self.seconds, self.setup_s = records, seconds, setup_s


def test_rate_takes_every_request_sent_over_the_span_to_the_last_resolution():
    # groups of 8 every 2.5 s; the fifth, sent before the close, resolves after it
    rs = [rec(0.0, 2.5 * g) for g in range(1, 5) for _ in range(8)] + \
         [rec(9.0, 12.5) for _ in range(8)]
    run = Run(rs)
    assert windows.all_images(rs) == (40, 12.5)
    assert reader("end_to_end", "images_per_s")(run) == 40 / 12.5


def test_a_stall_at_the_end_of_the_window_lowers_the_rate():
    steady = [rec(0.0, 2.5 * g) for g in range(1, 5) for _ in range(8)]
    stalled = steady + [rec(9.0, 40.0) for _ in range(8)]
    rate = reader("end_to_end", "images_per_s")
    assert rate(Run(stalled)) == 40 / 40.0 < rate(Run(steady)) == 32 / 10.0
    # a request that failed late still takes its time, and brings no image
    failed = steady + [rec(9.0, 30.0, ok=False)]
    assert windows.all_images(failed) == (32, 30.0)
    assert rate(Run(failed)) == 32 / 30.0


def test_tail_takes_every_request_and_failures_count_as_infinite():
    rs = [rec(0.0, 1.0 + i / 10) for i in range(20)]
    assert windows.percentile(windows.latencies(rs), 0.9) == 1.0 + 17 / 10
    assert math.isclose(reader("end_to_end", "latency_p90_s")(Run(rs)), 2.7)
    rs += [rec(0.0, None, ok=False) for _ in range(3)]
    assert windows.percentile(windows.latencies(rs), 0.9) == math.inf
    assert reader("end_to_end", "latency_p90_s")(Run(rs)) is None


def test_nearest_rank_percentile():
    assert windows.percentile([3, 1, 2], 0.5) == 2
    assert windows.percentile(list(range(1, 101)), 0.9) == 90
    assert windows.percentile([], 0.9) is None


def test_setup_reader():
    assert reader("end_to_end", "setup_s")(Run([])) == 3.0
