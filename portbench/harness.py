"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything a cell needs comes from files found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<name>.json``), its
traffic (``traffic/<name>.json``, driven by :mod:`loadgen`), its check
settings (``cells/<cell>.json``) and one reader per metric (``e2e/<name>.py``,
``metrics/<name>.py``). The program under test is ``pww_tpu_torch``; its
pipeline gets the weights the benchmark drew and the benchmark's tokenizer,
and is driven only through the entry the traffic names.

In a traced run (``trace=True``) the pipeline records its phase times
(``profile=True``, which synchronises the card at each phase's end), and
calls of the program from the cell's ``profile_call``-th in the window on
run under the profiler (:class:`Taps`, :mod:`trace`). The end-to-end
metrics come from untraced runs only.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

from . import check, loadgen, manifest, modelcfg, weights
from .wordtok import WordTokenizer

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "pww_tpu")
KERNELS = {"K1": ("cross_attention_kernel", "fused_pww_reduce"),
           "K2": ("cross_attention_kernel", "fused_pww_cross_attention"),
           "K3": ("flash_attention", "flash_self_attention")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``pww_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cell_settings(name: str, root: str = HERE) -> Dict:
    with open(os.path.join(root, "cells", name + ".json")) as f:
        return json.load(f)


class Taps:
    """Wrappers around the pipeline's methods (instance attributes; the
    program is not changed): ``units`` records each call of the window
    (latent h, latent w, CFG rows, visits), and the ``profile_index``-th
    call of the entry runs under the profiler, with the K1-K3 launches it
    made, the card's activity alone (where its trace cannot be read, the
    next call, up to three); the call after the one read, with the host's
    operations too, which only name the idle gaps (:mod:`trace`). The
    profiler slows both calls (the second by far), so their phase times and
    units are kept apart (``profiled``) from the window's others."""

    def __init__(self, pipe, mix: Dict, profile_index: Optional[int]):
        self.armed = False
        self.units: List = []
        self.profiled: List = []  # (timer lengths, units) before and after each
        self.trace = self.trace_units = self.host_trace = None
        self.launches: Dict[str, int] = {}
        self.calls = self.tries = 0
        self.host_tried = False
        entry = visit = "generate_batch" if mix["entry"] == "batcher" else "generate"
        inner = getattr(pipe, visit)

        def visits(*a, **kw):
            if self.armed:
                self.units.append(self._unit(visit, a, kw))
            return inner(*a, **kw)

        setattr(pipe, visit, visits)
        outer = getattr(pipe, entry)

        def entry_call(*a, **kw):
            self.calls += 1
            device_turn = (self.trace is None and self.tries < 3
                           and self.calls > (profile_index or 0))
            host_turn = self.trace is not None and not self.host_tried
            if not self.armed or profile_index is None or not (device_turn or host_turn):
                return outer(*a, **kw)
            from . import trace

            lengths = {k: len(v) for k, v in pipe.timers.times.items()}
            before, n_units = self._counts(), len(self.units)
            if host_turn:  # host operations too, to name the gaps
                self.host_tried = True
                out, self.host_trace = trace.profile_call(lambda: outer(*a, **kw), True)
            else:
                self.tries += 1
                out, self.trace = trace.profile_call(lambda: outer(*a, **kw), False)
                after = self._counts()
                self.launches = {k: after[k] - before[k] for k in after}
                self.trace_units = self.units[n_units:]
            self.profiled.append((lengths, {k: len(v) for k, v in pipe.timers.times.items()},
                                  n_units, len(self.units)))
            return out

        setattr(pipe, entry, entry_call)

    def unprofiled(self, timers: Dict[str, List[float]]):
        """(timers, units) of the window's calls that ran without the
        profiler."""
        drop_t = {k: set() for k in timers}
        drop_u = set()
        for t0, t1, u0, u1 in self.profiled:
            for k in timers:
                drop_t[k].update(range(t0.get(k, 0), t1.get(k, 0)))
            drop_u.update(range(u0, u1))
        return ({k: [x for i, x in enumerate(v) if i not in drop_t[k]] for k, v in timers.items()},
                [u for i, u in enumerate(self.units) if i not in drop_u])

    @staticmethod
    def _counts() -> Dict[str, int]:
        import importlib

        return {k: getattr(importlib.import_module(f"pww_tpu_torch.ops.{mod}"), fn).launches
                for k, (mod, fn) in KERNELS.items()}

    @staticmethod
    def _unit(method: str, a, kw):
        if method == "generate_batch":
            reqs = a[0] if a else kw["requests"]
            h, w = reqs[0]["color_map_image"].shape[:2]
            return (h // 8, w // 8, 2 * len(reqs), int(kw.get("num_inference_steps", 30)))
        h, w = kw["color_map_image"].shape[:2]
        return (h // 8, w // 8, 2 * int(kw.get("num_samples", 1)),
                int(kw.get("num_inference_steps", 30)))


def warm(mix: Dict, call, steps: int, max_batch: int) -> None:
    """Every size of the mix once through the timed entry, a full group for
    the batcher, at ``steps`` steps."""
    for i, size in enumerate(mix["sizes"]):
        one = dict(mix, sizes=[size], steps=steps)
        reqs = [loadgen.make_request(one, 0, 1 << 30, i * max_batch + k)
                for k in range(max_batch if mix["entry"] == "batcher" else 1)]
        outs = [call(r) for r in reqs]
        for o in outs:
            o.result() if hasattr(o, "result") else o


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def setup(cell: str, seed: int, trace: bool, device: str = "cuda", dtype=None,
          root: Optional[str] = None) -> SimpleNamespace:
    """Everything before the window: the cell's files, the kernel library
    (built where it is not cached), the weights drawn from ``seed``, the
    pipeline (and the Batcher) and the warm-up of every shape. ``root``: the
    checkout (default: this file's). ``phases``: the seconds each part took,
    as the clock read at its end."""
    import torch

    from pww_tpu_torch.pipeline.pipeline import PwwPipeline
    from pww_tpu_torch.serving.batcher import Batcher

    from .reference.models import build

    stamps = [("imports", time.perf_counter())]

    root = root or os.path.dirname(HERE)
    pb = os.path.join(root, "portbench")
    man = manifest.load(root)
    w = manifest.workload(man, cell)
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    cfg = modelcfg.load(os.path.join(root, conf["file"]))
    mix = loadgen.load_mix(w["traffic"], pb)
    settings = cell_settings(cell, pb)
    dtype = dtype or getattr(torch, cfg.get("dtype", "bfloat16"))
    cuda = torch.device(device).type == "cuda"
    tok = WordTokenizer()
    tok2 = WordTokenizer(pad_token_id=0) if cfg.get("clip2") else None
    if cuda:
        from pww_tpu_torch.ops import cuda_build

        cuda_build.library()
        torch.cuda.synchronize()
    stamps.append(("kernels", time.perf_counter()))
    flat, params = weights.draw(weights.shapes_of(build(cfg, "meta")), seed, device, dtype)
    stamps.append(("weights", time.perf_counter()))
    pipe = PwwPipeline(modelcfg.program_config(cfg), params=params, tokenizer=tok,
                       tokenizer_2=tok2, scheduler="lms", device=device, dtype=dtype,
                       profile=bool(trace))
    batcher = Batcher(pipe, **mix["batcher"]) if mix["entry"] == "batcher" else None
    call = loadgen.call_for(mix, pipe, batcher)
    if cuda:
        torch.cuda.synchronize()
    stamps.append(("pipeline", time.perf_counter()))
    warm(mix, call, int(settings["warmup_steps"]),
         int(mix.get("batcher", {}).get("max_batch", 1)))
    if cuda:
        torch.cuda.synchronize()
    stamps.append(("warm", time.perf_counter()))
    return SimpleNamespace(pb=pb, man=man, w=w, cfg=cfg, mix=mix, settings=settings,
                           stamps=stamps,
                           cuda=cuda, tok=tok, tok2=tok2, flat=flat, params=params, pipe=pipe,
                           batcher=batcher, call=call)


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", dtype=None, root: Optional[str] = None) -> Dict:
    """One run; returns the result line's dict (``check`` last)."""
    import torch

    ctx = setup(cell, seed, trace, device, dtype, root)
    pb, man, w, cfg, mix, settings, cuda = (ctx.pb, ctx.man, ctx.w, ctx.cfg, ctx.mix,
                                            ctx.settings, ctx.cuda)
    pipe, batcher, call = ctx.pipe, ctx.batcher, ctx.call
    if trace:
        from . import trace as tr

        tr.prime()
    taps = Taps(pipe, mix, settings["profile_call"] if trace else None)
    pipe.timers.times.clear()
    stats0 = dict(batcher.stats) if batcher else None
    setup_s = time.perf_counter() - t_start
    marks = [("start", t_start)] + ctx.stamps
    print("[portbench] setup_s " + " ".join(
        f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:], 0))
        + f" taps {t_start + setup_s - marks[-1][1]:.3f}", file=sys.stderr)

    taps.armed = True
    window = loadgen.run_window(mix, call, seed, seconds)
    taps.armed = False
    records = window["records"]
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = ({k: batcher.stats[k] - stats0[k] for k in stats0} if batcher else None)
    timers, units = taps.unprofiled({k: list(v) for k, v in pipe.timers.times.items()})
    state = SimpleNamespace(
        records=records, seconds=float(seconds), setup_s=setup_s, config=cfg,
        config_name=w["config"], mix=mix, timers=timers,
        units=units, trace=taps.trace, trace_units=taps.trace_units,
        host_trace=taps.host_trace,
        launches=taps.launches, batcher_stats=stats)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mdef in manifest.metrics_of(man, cell, kind):
        value = manifest.reader(kind, mdef["name"], pb)(state)
        if value is not None:
            metrics[mdef["name"]] = {"value": float(value), "unit": mdef["unit"]}

    if batcher is not None:
        batcher.close()
    tok, tok2, flat, params = ctx.tok, ctx.tok2, ctx.flat, ctx.params
    del call, batcher, pipe, taps, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    picked = check.sample(records, int(settings["check"]["sample"]), seed)
    ref = check.build_reference(cfg, params, device, tok, tok2)
    del flat, params
    by_size: Dict = {}
    for r in picked:
        by_size.setdefault(r.image.shape, []).append(r)
    pairs = []
    for group in by_size.values():
        want = check.reference_images(ref, mix, [r.request for r in group],
                                      int(settings["check"]["rows"]))
        pairs += [(r.image, b) for r, b in zip(group, want)]
    failed = sum(r.image is None for r in records)
    for r in [r for r in records if r.image is None][:3]:
        print(f"[portbench] request {r.client}/{r.k} failed: {r.error}", file=sys.stderr)
    numbers, correct = check.judge(pairs, failed, settings["check"]["image_rel_l2"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and state.trace is not None:
        dev["busy_s"] = tr.busy_us(tr.within(state.trace)) / 1e6
        dev["window_s"] = tr.window_us(state.trace) / 1e6
        gaps = tr.breakdown(state.host_trace)["idle_gaps"] if state.host_trace else []
        out["breakdown"] = {"device_ops": tr.breakdown(state.trace)["device_ops"],
                            "idle_gaps": gaps}
    if cuda:
        out["power_limit"] = power_limit()
    out["check"] = numbers
    return out
