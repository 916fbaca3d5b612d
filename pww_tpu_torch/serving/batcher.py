"""Request micro-batching for serving.

Port of :mod:`pww_tpu.serving.batcher`. The reference serves requests one at
a time in a host loop that reloads every model (reference
`gradio_pww.py:31-45`). Here a worker thread drains the queue, groups
requests by a compatibility key (resolution, map grid, steps, guidance,
weight function, text length, mode) and runs each group as ONE
:meth:`~pww_tpu_torch.pipeline.pipeline.PwwPipeline.generate_batch` call,
so that concurrent users share one batched denoise.

On the card the worker launches with ``output_type="device"`` and records a
CUDA event on its stream after the decode: that event is the compute
barrier (the JAX package fetches one pixel instead). A single fetcher
thread waits for the event, releases the backpressure, then copies the
images into pinned host memory on a stream of its own (``record_stream``
keeps the caching allocator from handing the tensor out while the copy
runs) and resolves the futures in launch order, so that no device-to-host
copy holds up the next launch. Requests that ``generate_batch`` cannot run
(:func:`_is_singleton`) go through ``generate`` alone.

On a mesh (a pipeline built with ``mesh=``, one process per rank) every
rank must make the same pipeline calls in the same order. Rank 0's
``Batcher`` forms the groups as above and, before each call it makes
(retries included), broadcasts the call's name and arguments (the request
dicts, maps as numpy arrays) over a gloo group; every other rank runs
:func:`follow`, which receives each call and makes it. A request that fails
fails in ``generate_batch``'s validation, before any collective, on every
rank alike, so no rank is left waiting. :meth:`Batcher.close` sends the stop
that ends the followers. The HTTP front end, the metrics and the latency
stats stay on rank 0. A callable weight function cannot be sent (it does
not pickle): on a mesh, requests take :class:`~pww_tpu_torch.ops.
weight_functions.WeightFunction` values.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class _Pending:
    request: Dict
    key: Tuple
    future: Future = field(default_factory=Future)
    # fetch-failure requeues used: one per request (a failure under
    # overlapped launches may be transient, a second one is real)
    retries: int = 0


@dataclass
class _Launch:
    """A launched group: its (N, H, W, 3) uint8 images (a tensor on the card
    or the host, or anything numpy reads) and, on the card, the event
    recorded after its decode."""

    images: Any
    event: Optional["torch.cuda.Event"] = None


def _is_singleton(req: Dict) -> bool:
    """Requests that cannot ride ``generate_batch``: per-step conditioning
    switches, inpaint-only-masked (a crop and paste-back per request),
    ControlNet, T2I-Adapter and IP-Adapter hints, several samples, the
    ensemble cut points and SDXL's micro-conditioning overrides. They run
    through ``generate`` alone; the JAX package's routing, unchanged."""
    return bool(
        req.get("prompt_editing")
        or req.get("inpaint_full_res")
        or req.get("control_image") is not None
        or req.get("ip_adapter_image") is not None
        or req.get("adapter_image") is not None
        or int(req.get("num_samples", 1)) != 1
        or req.get("denoising_end") is not None
        or req.get("denoising_start") is not None
        or req.get("original_size") is not None
        or req.get("target_size") is not None
    )


def control_group():
    """The group that carries rank 0's calls to the followers: the world
    where it is gloo, else a gloo group of the world's ranks (made once per
    ``Batcher`` / :func:`follow`, by every rank in the same order)."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def follow(pipeline) -> Dict[str, int]:
    """Every rank but 0 of a mesh pipeline: receive each call rank 0's
    ``Batcher`` makes and make it, in its order, until the ``Batcher``
    closes. A call that raises here raises on rank 0 too, which resolves
    the requests' futures with the error; the loop goes on. Returns
    {"calls", "errors"}."""
    if getattr(pipeline, "mesh", None) is None or dist.get_rank() == 0:
        raise ValueError("follow(pipeline) runs on the ranks other than 0 of a pipeline "
                         "on a mesh; rank 0 runs the Batcher")
    group = control_group()
    stats = {"calls": 0, "errors": 0}
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, group=group)
        name, args, kwargs = msg[0]
        if name is None:
            return stats
        stats["calls"] += 1
        try:
            getattr(pipeline, name)(*args, **kwargs)
        except Exception:
            stats["errors"] += 1


def _image_shape_hw(img) -> Tuple[int, int]:
    arr = np.asarray(img)
    return int(arr.shape[0]), int(arr.shape[1])


def compat_key(req: Dict, tokenizer=None) -> Tuple:
    """The key that requests of one ``generate_batch`` call share; a
    singleton gets a key that equals no other (a fresh ``object()``).

    The processing size (the init image's floored to 32 for img2img, else
    the color map's), the map grid (it keys the weight pyramids), steps,
    guidance, the weight function, the options ``generate_batch`` takes
    for the whole batch, the long-prompt window count (with a tokenizer),
    and the mode: img2img, inpaint, strength and noise mode."""
    if _is_singleton(req):
        return ("singleton", object())
    cm = req.get("color_map_image")
    init = req.get("init_image")
    map_grid = None if cm is None else _image_shape_hw(cm)
    if init is not None:
        ih, iw = _image_shape_hw(init)
        shape = (ih - ih % 32, iw - iw % 32)
    elif cm is not None:
        shape = map_grid
    else:
        shape = (512, 512)
    i2i = init is not None
    mode = (
        i2i,
        req.get("mask_image") is not None,
        float(req.get("strength", 0.5)) if i2i else None,
        str(req.get("noise_mode", "jax")),
    )
    long_p = bool(req.get("long_prompts", False))
    n_win = 0
    if long_p and tokenizer is not None:
        from ..conditioning.encode import _window_ids

        max_len = tokenizer.model_max_length
        n_win = max(len(_window_ids(tokenizer, req.get("prompt", ""), max_len)),
                    len(_window_ids(tokenizer, req.get("negative_prompt", ""), max_len)))
    return (
        shape,
        map_grid,
        int(req.get("num_inference_steps", 30)),
        float(req.get("guidance_scale", 7.5)),
        repr(req.get("weight_function")),
        int(req.get("cache_interval", 1)),
        float(req.get("tome_ratio", 0.0)),
        repr(req.get("freeu")),
        (long_p, n_win),
        float(req.get("sag_scale", 0.0)),
        mode,
    )


class Batcher:
    """Coalesces requests into ``pipeline.generate_batch`` calls.

    Args:
      pipeline: a :class:`~pww_tpu_torch.pipeline.pipeline.PwwPipeline`
        (on the card unless it was built on the CPU); on a mesh, the
        ``Batcher`` runs on rank 0 and the other ranks :func:`follow`.
      max_batch: the most requests fused into one call.
      max_wait_ms: how long the first request of a group waits for company
        while the device is idle.
      max_batch_pixels: cap a group's output pixels (rows · h · w), so that
        large sizes form smaller groups; None: no cap.
    """

    def __init__(self, pipeline, max_batch: int = 8, max_wait_ms: float = 25.0,
                 max_batch_pixels: Optional[int] = None):
        self._mesh = getattr(pipeline, "mesh", None)
        if self._mesh is not None:
            if dist.get_rank() != 0:
                raise ValueError("on a mesh the Batcher runs on rank 0; the other ranks call "
                                 "serving.batcher.follow(pipeline)")
            self._group = control_group()
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.max_batch_pixels = None if max_batch_pixels is None else int(max_batch_pixels)
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # launched groups whose compute is not confirmed finished: while > 0
        # the device is busy and group formation keeps draining. The fetcher
        # lowers it at the compute barrier, before the copy to the host.
        self._computing = 0
        self._computing_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._last_launch: Optional[_Launch] = None  # worker thread only
        self._fetch_stream = None  # the fetcher's CUDA stream, made on first use
        # unet_visits: the denoise visits of the pipeline's calls; graph_visits:
        # those replayed from a CUDA graph (pipeline/graphs.py)
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0, "retries": 0,
                      "unet_visits": 0, "graph_visits": 0}
        self._latencies = deque(maxlen=1024)  # seconds, per finished request
        # one fetch thread: resolves launched groups in launch order
        self._fetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pww-fetch")
        self._worker = threading.Thread(target=self._run, daemon=True, name="pww-batcher")
        self._worker.start()

    def observe_latency(self, seconds: float) -> None:
        """Record one finished request's wall latency (handler side)."""
        self._latencies.append(float(seconds))

    def metrics(self) -> Dict:
        """Counters, batch efficiency and latency percentiles over the last
        1024 requests."""
        lat = sorted(self._latencies.copy())  # handler threads append meanwhile
        out = dict(self.stats)
        out["batch_efficiency"] = (self.stats["batched_requests"] / self.stats["batches"]
                                   if self.stats["batches"] else None)
        for name, q in (("latency_p50_s", 0.50), ("latency_p95_s", 0.95)):
            out[name] = round(lat[min(len(lat) - 1, int(q * len(lat)))], 4) if lat else None
        out["latency_samples"] = len(lat)
        return out

    def submit(self, request: Dict) -> Future:
        """Enqueue a request dict (``generate_batch``'s schema); returns a
        Future that resolves to a PIL image."""
        p = _Pending(request=request,
                     key=compat_key(request, getattr(self.pipeline, "tokenizer", None)))
        with self._stats_lock:
            self.stats["requests"] += 1
        self._q.put(p)
        return p.future

    def close(self):
        """Stop the worker (on a mesh: after its call in flight, then the
        followers' stop) and the fetcher."""
        self._stop.set()
        self._worker.join(timeout=None if self._mesh is not None else 5)
        self._fetcher.shutdown(wait=True)

    def _call(self, name: str, *args, **kwargs):
        """``pipeline.<name>(*args, **kwargs)``; on a mesh, sent to the
        followers first (worker thread only: one order of calls)."""
        if self._mesh is not None:
            dist.broadcast_object_list([(name, args, kwargs)], src=0, group=self._group)
        return getattr(self.pipeline, name)(*args, **kwargs)

    # -- worker --------------------------------------------------------------
    def _cap_for(self, key) -> int:
        """A group's row cap: ``max_batch``, tightened by ``max_batch_pixels``
        at the group's size (``key[0]``)."""
        if self.max_batch_pixels is None or not key or key[0] == "singleton":
            return self.max_batch
        h, w = key[0]
        return max(1, min(self.max_batch, self.max_batch_pixels // (h * w)))

    def _drain_group(self, first: _Pending) -> List[_Pending]:
        if first.key and first.key[0] == "singleton":
            return [first]  # no request can join it
        group = [first]
        cap = self._cap_for(first.key)
        deadline = time.monotonic() + self.max_wait
        leftovers: List[_Pending] = []
        while len(group) < cap and not self._stop.is_set():
            # While a launched group still computes, closing this one early
            # cannot start it sooner, and would shut out the requests that
            # arrive meanwhile: keep draining until the device is idle, then
            # let the linger deadline close the group. A full group launches
            # at once.
            busy = self._computing > 0
            now = time.monotonic()
            if not busy and now >= deadline:
                break
            try:
                nxt = self._q.get(timeout=0.005 if busy else deadline - now)
            except queue.Empty:
                continue
            if nxt.key == first.key:
                group.append(nxt)
            else:
                leftovers.append(nxt)
        for lo in leftovers:
            self._q.put(lo)
        return group

    def _launch(self, call) -> _Launch:
        """Run ``call()`` (a ``generate``/``generate_batch`` with
        ``output_type="device"``) and record its compute barrier."""
        images = call()
        event = None
        if isinstance(images, torch.Tensor) and images.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(images.device))
        return _Launch(images, event)

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = self._drain_group(first)
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(group)
            visits = self._visits()
            try:
                if group[0].key and group[0].key[0] == "singleton":
                    self._run_singleton(group[0])
                else:
                    self._run_group(group)
            except Exception as e:  # to every waiter
                for p in group:
                    if not p.future.done():
                        p.future.set_exception(e)
            unet, graph = (now - before for now, before in zip(self._visits(), visits))
            self.stats["unet_visits"] += unet
            self.stats["graph_visits"] += graph
        if self._mesh is not None:  # the followers' stop, after the last call
            dist.broadcast_object_list([(None, None, None)], src=0, group=self._group)

    def _visits(self) -> Tuple[int, int]:
        """The pipeline's (UNet visits, graph visits) so far; (0, 0) for a
        pipeline that does not count them."""
        graphs = getattr(self.pipeline, "unet_graphs", None)
        return (0, 0) if graphs is None else graphs.visits()

    def _run_singleton(self, p: _Pending) -> None:
        """A singleton through ``generate``; where ``generate`` refuses device
        output (it needs host post-processing), a synchronous fetch."""
        from PIL import Image

        try:
            self._sync_prev_compute()
            launch = self._launch(lambda: self._call(
                "generate", **p.request, output_type="device"))
        except ValueError as e:
            if 'output_type="device"' not in str(e):
                raise
            img = self._call("generate", **p.request, output_type="np")
            p.future.set_result(Image.fromarray(np.asarray(img)[0]))
            return
        except Exception:
            # a launch that fails under overlapped work (out of memory) is
            # retried once, synchronously, on the drained device
            self._full_sync()
            self.stats["retries"] += 1
            img = self._call("generate", **p.request, output_type="np")
            p.future.set_result(Image.fromarray(np.asarray(img)[0]))
            return
        self._hand_to_fetcher([p], launch)

    def _run_group(self, group: List[_Pending]) -> None:
        from PIL import Image

        g0 = group[0].request  # the batch-level options: one key, one value
        common = dict(
            num_inference_steps=g0.get("num_inference_steps", 30),
            guidance_scale=g0.get("guidance_scale", 7.5),
            weight_function=g0.get("weight_function"),
            cache_interval=g0.get("cache_interval", 1),
            tome_ratio=g0.get("tome_ratio", 0.0),
            freeu=g0.get("freeu"),
            sag_scale=g0.get("sag_scale", 0.0),
            strength=g0.get("strength", 0.5),
            noise_mode=g0.get("noise_mode", "jax"),
        )
        reqs = [p.request for p in group]
        try:
            self._sync_prev_compute()
            launch = self._launch(lambda: self._call(
                "generate_batch", reqs, output_type="device", **common))
        except Exception:
            # first taken for memory exhausted by overlapped work: drain
            # everything in flight, then retry the same batch once,
            # synchronously, on the idle device
            self._full_sync()
            self.stats["retries"] += 1
            try:
                arr = np.asarray(self._call("generate_batch", reqs,
                                            output_type="np", **common))
                for p, im in zip(group, arr):
                    p.future.set_result(Image.fromarray(im))
                return
            except Exception:
                if len(group) == 1:
                    raise
            # still failing on an idle device: one request's error must not
            # fail its neighbours, so each runs alone
            for p in group:
                try:
                    img = self._call("generate_batch", [p.request],
                                     output_type="np", **common)
                    p.future.set_result(Image.fromarray(np.asarray(img)[0]))
                except Exception as pe:
                    if not p.future.done():
                        p.future.set_exception(pe)
            return
        self._hand_to_fetcher(group, launch)

    def _sync_prev_compute(self) -> None:
        """Wait for the previous launch's compute (not its copy), so that a
        launch never queues behind a running one (worker thread only)."""
        launch, self._last_launch = self._last_launch, None
        if launch is None or launch.event is None:
            return
        try:
            launch.event.synchronize()
        except Exception:
            pass  # the fetcher's copy surfaces a real error

    def _full_sync(self, timeout_s: float = 600.0) -> None:
        """Drain all work in flight before a retry (worker thread only): the
        last launch's compute, every group the fetcher has not confirmed,
        then the whole card, and the allocator's cached blocks."""
        self._sync_prev_compute()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._computing_lock:
                if self._computing == 0:
                    break
            time.sleep(0.01)
        device = getattr(self.pipeline, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()

    def _hand_to_fetcher(self, group: List[_Pending], launch: _Launch) -> None:
        """Queue a launched group for the fetcher; it counts as computing
        until the fetcher passes its compute barrier."""
        self._last_launch = launch
        with self._computing_lock:
            self._computing += 1
        try:
            self._fetcher.submit(self._resolve_tracked, group, launch)
        except RuntimeError:  # close() shut the fetcher down meanwhile
            self._resolve_tracked(group, launch)

    def _resolve_tracked(self, group: List[_Pending], launch: _Launch) -> None:
        # the compute barrier first: the backpressure ends when the compute
        # does, while the copy to the host may still be running
        try:
            if launch.event is not None:
                try:
                    launch.event.synchronize()
                except Exception:
                    pass  # _resolve's copy surfaces a real error
        finally:
            with self._computing_lock:
                self._computing -= 1
        self._resolve(group, launch)

    def _to_host(self, launch: _Launch) -> np.ndarray:
        """The images on the host: from the card, a copy into pinned memory
        on the fetcher's stream after the launch's event."""
        x = launch.images
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            return np.asarray(x)
        if self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(x.device)
        stream = self._fetch_stream
        with torch.inference_mode(), torch.cuda.stream(stream):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            if launch.event is not None:
                stream.wait_event(launch.event)
            host.copy_(x, non_blocking=True)
            x.record_stream(stream)
        stream.synchronize()
        return host.numpy()

    def _resolve(self, group: List[_Pending], launch: _Launch) -> None:
        """Fetch one launched group and resolve its futures (fetcher thread,
        in launch order)."""
        from PIL import Image

        try:
            arr = self._to_host(launch)
        except Exception as e:
            # a failure of the launched work surfaces here: each request is
            # requeued once and relaunched; the second failure is real
            requeued = False
            for p in group:
                if p.future.done():
                    continue
                if p.retries == 0:
                    p.retries = 1
                    self._q.put(p)
                    requeued = True
                else:
                    p.future.set_exception(e)
            if requeued:
                self.stats["retries"] += 1
            return
        try:
            for p, im in zip(group, arr):
                p.future.set_result(Image.fromarray(im))
        except Exception as e:
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)
