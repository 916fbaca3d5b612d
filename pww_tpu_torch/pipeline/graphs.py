"""CUDA graphs of the denoise loop's UNet visits.

A visit of the batched-CFG path is one UNet forward: about a thousand
kernel launches (K1-K5, the convs, the GEMMs and the glue between them),
each enqueued by Python. Where the host enqueues a visit about as fast as
the card runs it, the card waits on Python between launches.
:class:`VisitGraphs` runs a visit signature's first visit eagerly (cuDNN and
cuBLAS pick their algorithms, the allocator warms), captures its second as
a CUDA graph, and replays that graph for every later visit with the
signature: the same launches, in the same order, on the same inputs, from
one graph launch. The scheduler's math stays eager around it.

Each graph owns its inputs. A call binds its constant inputs (text states,
the PwW pyramid, SDXL's added conditions, the IP tokens) once, at its first
replay; each visit copies the latents, the timestep and sigma in. A
visit's copies, its replay and the copy of its output out of the graph are
enqueued on the caller's current stream under one lock, so that two
threads may interleave visits. The live graphs of one :class:`VisitGraphs`
share one memory pool (a capture joins the pool of a graph still held; the
first, or the first after every graph was dropped, starts a new one): a
replay overwrites the pool, which is safe because every replay's output is
copied out before another graph replays.

The kernel wrappers count launches on the host (``.launches``), and a
capture runs their host code without running a kernel: the counters are
put back after a capture, and each replay adds the captured visit's
launches, so that the counts stay those of the visits run.

:func:`engages` is the rule that picks the graph: a call on CUDA outside
autograd on the batched CFG path, without ControlNet or T2I residuals,
DeepCache, SAG, ToMe, FreeU, prompt editing or a mesh. Every other call
runs the eager loop as before.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.cross_attention_kernel import (fused_pww_cross_attention, fused_pww_reduce,
                                          prepare_capture_stream)
from ..ops.flash_attention import flash_self_attention
from ..ops.group_norm import group_norm, group_norm_apply, group_norm_stats
from ..ops.layer_norm import layer_norm

# every kernel wrapper that counts its launches in ``.launches``
LAUNCH_COUNTERS = (fused_pww_reduce, fused_pww_cross_attention, flash_self_attention,
                   group_norm, group_norm_stats, group_norm_apply, layer_norm)
CAPACITY = 16  # graphs kept per pipeline, the least recently replayed dropped first

Inputs = Dict[str, torch.Tensor]


def engages(device: torch.device, *, split: bool, control, adapter, cache_interval: int,
            sag_scale: float, conds, tome_ratio: float, freeu, whole: bool) -> bool:
    """Whether a denoise call replays its UNet visits from CUDA graphs:
    on CUDA, outside autograd, on the batched CFG path (``split`` false),
    with no ControlNet (``control``) or T2I-Adapter (``adapter``)
    residuals, ``cache_interval`` 1, ``sag_scale`` 0, no per-step
    ``conds`` (prompt editing), no ToMe or FreeU, and the call's rows
    whole on one process (``whole``: no mesh)."""
    return (device.type == "cuda" and not torch.is_grad_enabled() and not split
            and not control and adapter is None and cache_interval == 1 and sag_scale == 0
            and conds is None and tome_ratio == 0 and freeu is None and whole)


def signature(unet: torch.nn.Module, generation: int, inputs: Inputs, weight_fn,
              ip_scale: Optional[float]) -> Tuple:
    """What a captured visit bakes in: the UNet module and its weights'
    generation, every input's name, shape, stride, dtype and device (rows,
    latent size and channels, context length, the pyramid's keys, the
    added conditions and IP tokens), the weight function (sigma mode,
    scale, reduction) and the IP scale, and whether inference mode is on
    (the static inputs are made in it)."""
    shapes = tuple((name, tuple(x.shape), x.stride(), x.dtype, x.device)
                   for name, x in sorted(inputs.items()))
    return (id(unet), generation, torch.is_inference_mode_enabled(), weight_fn, ip_scale,
            shapes)


def _counts():
    return [c.launches for c in LAUNCH_COUNTERS]


class CudaCapture:
    """Captures on a side stream of ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        prepare_capture_stream(self.stream)

    def __call__(self, fn: Callable[[Inputs], torch.Tensor], inputs: Inputs, share=None):
        """(graph, output buffer) of ``fn(inputs)``, in the memory pool of
        the live graph ``share`` (None: a new pool). Raises where ``fn``
        cannot be captured (a host sync, an unsafe call)."""
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # thread_local: the Batcher's fetcher may wait on events meanwhile
            graph.capture_begin(pool=None if share is None else share.pool(),
                                capture_error_mode="thread_local")
            try:
                out = fn(inputs)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        current.wait_stream(self.stream)
        return graph, out


class _Graph:
    def __init__(self, unet, graph, static: Inputs, out: torch.Tensor, launches):
        self.unet = unet  # alive while its weights are baked into the graph
        self.graph, self.static, self.out, self.launches = graph, static, out, launches
        self.bound = None  # the session whose constant inputs the static ones hold

    def load(self, inputs: Inputs) -> None:
        for name, x in inputs.items():
            self.static[name].copy_(x)


class VisitGraphs:
    """One pipeline's CUDA graphs of UNet visits, keyed by
    :func:`signature`, and its counts of visits: ``eager``, ``captured``
    (a capture and its first replay) and ``replayed``. ``capture``: the
    capture (default :class:`CudaCapture` on ``device``, made at the first
    capture). :meth:`invalidate` drops every graph where the weights change
    (a load, a LoRA merge or restore)."""

    def __init__(self, device: torch.device, capture=None):
        self.device = device
        self.generation = 0
        self.counts = {"eager": 0, "captured": 0, "replayed": 0}
        self._capture = capture
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = collections.OrderedDict()
        self._seen = set()  # signatures whose first visit ran eagerly
        self._tokens = itertools.count()
        self._lock = threading.Lock()

    def count_eager(self) -> None:
        """One visit of a call that the rule keeps eager."""
        with self._lock:
            self.counts["eager"] += 1

    def visits(self) -> Tuple[int, int]:
        """(UNet visits, those run from a graph) so far."""
        c = self.counts
        return c["eager"] + c["captured"] + c["replayed"], c["captured"] + c["replayed"]

    def invalidate(self) -> None:
        with self._lock:
            self.generation += 1
            self._graphs.clear()
            self._seen.clear()

    def session(self, unet: torch.nn.Module, fn: Callable[[Inputs], torch.Tensor],
                call_inputs: Inputs, visit_inputs: Inputs, weight_fn,
                ip_scale: Optional[float]) -> "Session":
        """A denoise call's visits: ``fn(inputs)`` is the UNet visit on
        ``call_inputs`` (constant through the call) and the visit's
        ``visit_inputs`` (of the shapes given here)."""
        key = signature(unet, self.generation, {**call_inputs, **visit_inputs}, weight_fn,
                        ip_scale)
        return Session(self, key, unet, fn, call_inputs, next(self._tokens))

    def _new(self, key, unet, fn, inputs: Inputs) -> _Graph:
        if self._capture is None:
            self._capture = CudaCapture(self.device)
        static = {name: x.clone() for name, x in inputs.items()}
        share = next(reversed(self._graphs.values())).graph if self._graphs else None
        before = _counts()
        try:
            graph, out = self._capture(fn, static, share)
        finally:
            launches = [a - b for a, b in zip(_counts(), before)]
            for c, n in zip(LAUNCH_COUNTERS, before):
                c.launches = n
        entry = _Graph(unet, graph, static, out, launches)
        self._graphs[key] = entry
        if len(self._graphs) > CAPACITY:
            self._graphs.popitem(last=False)
        return entry


class Session:
    """One call's visits through :class:`VisitGraphs`."""

    def __init__(self, graphs: VisitGraphs, key, unet, fn, call_inputs: Inputs, token: int):
        self.graphs, self.key, self.unet, self.fn = graphs, key, unet, fn
        self.call_inputs, self.token = call_inputs, token

    def visit(self, visit_inputs: Inputs) -> torch.Tensor:
        """The UNet's output for this visit, as a float32 copy."""
        g = self.graphs
        with g._lock:
            entry = g._graphs.get(self.key)
            if entry is None and self.key not in g._seen:
                g._seen.add(self.key)
                g.counts["eager"] += 1
                return self.fn({**self.call_inputs, **visit_inputs}).float()
            if entry is None:
                inputs = {**self.call_inputs, **visit_inputs}
                entry = g._new(self.key, self.unet, self.fn, inputs)
                g.counts["captured"] += 1
            else:
                if entry.bound != self.token:
                    entry.load(self.call_inputs)
                entry.load(visit_inputs)
                g._graphs.move_to_end(self.key)
                g.counts["replayed"] += 1
            entry.bound = self.token
            entry.graph.replay()
            for c, n in zip(LAUNCH_COUNTERS, entry.launches):
                c.launches += n
            return entry.out.to(torch.float32, copy=True)
