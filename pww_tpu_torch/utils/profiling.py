"""Tracing, phase timers and NaN checks.

Port of :mod:`pww_tpu.utils.profiling`:

  * :class:`PhaseTimer`: wall-clock seconds per pipeline phase (encode /
    denoise / decode), each ``phase()`` block ending in a synchronise of
    the card its ``sync`` tensor lives on, so that device work is inside
    the reading; queryable counters (p50, total, images/sec);
  * :func:`trace`: ``torch.profiler`` over a block, written as a Chrome
    trace into a directory;
  * :func:`enable_nan_checks`: torch has no counterpart of
    ``jax_debug_nans``; a global forward hook on every module raises
    ``FloatingPointError`` naming the first module whose output holds a
    non-finite value.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


def _sync(x) -> None:
    """Wait for the device work behind the tensor(s) ``x``."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (list, tuple)):
        for t in x:
            _sync(t)
    elif isinstance(x, dict):
        for t in x.values():
            _sync(t)


class PhaseTimer:
    """Accumulates per-phase timings; every ``phase()`` block syncs the device."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; ``sync``: a tensor (or a list or dict of them)
        whose card is synchronised before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.times[name].append(seconds)

    def p50(self, name: str) -> Optional[float]:
        xs = self.times.get(name)
        return statistics.median(xs) if xs else None

    def total(self, name: str) -> float:
        return sum(self.times.get(name, []))

    def images_per_sec(self, name: str, images_per_call: int = 1) -> Optional[float]:
        p = self.p50(name)
        return images_per_call / p if p else None

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "count": len(v),
                "p50_s": statistics.median(v),
                "total_s": sum(v),
            }
            for k, v in self.times.items()
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` (CPU, and CUDA where a card is there) over the
    block; on exit a Chrome trace ``trace.json`` is written into
    ``log_dir`` (created). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_nan_hook = None


def _check_finite(module: torch.nn.Module, inputs, output) -> None:
    outs = output if isinstance(output, (tuple, list)) else (output,)
    for t in outs:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"non-finite value in the output of {type(module).__name__}")


def enable_nan_checks(on: bool = True) -> None:
    """Raise ``FloatingPointError`` at the first module (any
    ``torch.nn.Module``, process-wide) whose forward output holds a NaN or
    an infinity. Each check reads a flag back from the device, so every
    module's forward synchronises the card while the checks are on: a
    debugging aid, not for timed runs. ``on=False`` removes the hook."""
    global _nan_hook
    if on and _nan_hook is None:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(_check_finite)
    elif not on and _nan_hook is not None:
        _nan_hook.remove()
        _nan_hook = None
