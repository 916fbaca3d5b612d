"""One program call under ``torch.profiler``, reduced in memory.

The profiled unit is one call of the program (a group of the batcher, or
one image), from its start until the card has finished it. Marker kernels
bracket it, with the card synchronised after them: 32 fills of a uint8
buffer before, three of an int16 buffer after, so that the unit is [the
last "before" marker's end, the first "after" marker's start] on the
trace's clock. Before them, a warm-up step whose events are dropped, then
a pause of 0.1 s and eight fills once the profiler records; after them, a
pause of 0.1 s and eight more fills before it stops: the profiler drops
device events that lie too near either end of its window (without the
pauses, the "after" markers of half the calls, and once every "before"
marker of a call traced with the host's operations). A trace that lacks
either kind of marker is not read: the harness profiles a later call.

With ``host=False`` only the card's activity is recorded: that unit gives
the busy and idle time, the kernels' times and the rooflines. Recording
every host operation as well (``host=True``) doubles the host's time a
call at batch 1, so that trace serves only to name the host's operations
open across the idle gaps. Nothing is written to disk: the events become
plain tuples here, and readers take their numbers from those.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Tuple

BEFORE, AFTER = "FillFunctor<unsigned char>", "FillFunctor<short>"  # the markers' names


def prime() -> None:
    """Start and stop the profiler once on this (the main) thread: the
    profiled call may run on the Batcher's worker thread, and the profiler's
    device client registers on the thread that first starts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_call(fn: Callable[[], object], host: bool) -> Tuple[object, Dict]:
    """(fn's result, the reduced trace, or None where the trace lacks the
    call) with ``fn`` run under the profiler, between the marker kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def fill(n):
        for _ in range(n):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def mark(dtype, n):
        for _ in range(n):
            torch.empty(4096, dtype=dtype, device="cuda").fill_(0x25)
        torch.cuda.synchronize()

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1,
                                                    repeat=1)) as prof:
        fill(8)
        time.sleep(0.2)
        prof.step()
        time.sleep(0.1)
        fill(8)
        mark(torch.uint8, 32)
        out = fn()
        torch.cuda.synchronize()
        mark(torch.int16, 3)
        time.sleep(0.1)
        fill(8)
        prof.step()
    try:
        return out, reduce_events(prof.events())
    except RuntimeError as e:  # the call itself ran: its answer stands
        print(f"[portbench] profiled call not read: {e}", file=sys.stderr)
        return out, None


def reduce_events(events) -> Dict:
    """{"unit": (start, end), "device": [(name, start, end)], "host":
    [(name, start, end)]}, microseconds on the trace's clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == cuda:
            # the profiler's own step annotations are no device work
            if not ev.name.startswith("ProfilerStep"):
                device.append((ev.name, tr.start, tr.end))
        else:
            host.append((ev.name, tr.start, tr.end))
    before = [e for n, s, e in device if BEFORE in n]
    after = [s for n, s, e in device if AFTER in n]
    if len(before) != 32 or len(after) != 3:
        print(f"[portbench] the trace holds {len(before)} of the 32 markers before the "
              f"call and {len(after)} of the 3 after it", file=sys.stderr)
    if not before or not after:
        raise RuntimeError("the markers on one side of the profiled call are missing")
    unit = (max(before), min(after))
    device = [d for d in device if BEFORE not in d[0] and AFTER not in d[0]]
    if not any(s >= unit[0] and e <= unit[1] for _, s, e in device):
        raise RuntimeError("the profiled call left no device event in the trace")
    return {"unit": unit, "device": device, "host": host}


def within(trace: Dict) -> List[Tuple[str, float, float]]:
    """The device events inside the profiled unit, clipped to it."""
    u0, u1 = trace["unit"]
    return [(n, max(s, u0), min(e, u1)) for n, s, e in trace["device"] if e > u0 and s < u1]


def busy_us(intervals) -> float:
    """The union of [start, end) intervals, in the input's unit."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window_us(trace: Dict) -> float:
    u0, u1 = trace["unit"]
    return u1 - u0


def kernel_us(trace: Dict, fragments) -> Tuple[float, int]:
    """Device time and count of the unit's events whose name holds any of
    ``fragments``."""
    sel = [(s, e) for n, s, e in within(trace) if any(f in n for f in fragments)]
    return sum(e - s for s, e in sel), len(sel)


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, by name, and the longest
    gaps with no device event, each named by the innermost host operation
    open across its middle."""
    dev = within(trace)
    by_name: Dict[str, float] = {}
    for n, s, e in dev:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    u0, u1 = trace["unit"]
    gaps, cur = [], u0
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if u1 > cur:
        gaps.append((cur, u1))
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (g0 + g1) / 2
        open_ops = [(e - s, n) for n, s, e in trace["host"]
                    if s <= mid <= e and not n.startswith("ProfilerStep")]
        named.append([min(open_ops)[1][:120] if open_ops else "python, no op open",
                      (g1 - g0) / 1e6])
    return {"device_ops": [[n, t / 1e6] for n, t in ops], "idle_gaps": named}
