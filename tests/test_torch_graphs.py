"""CUDA graphs of the denoise loop's UNet visits (pww_tpu_torch/pipeline/
graphs.py), on the CPU: the rule that engages them, the visit signature and
its invalidation on a weight change, the kernels' launch counts under
capture and replay, the Batcher's visit counters and their reader in
portbench. A CPU stand-in takes the capture's place: it runs the visit at
capture (the wrappers' host code) and again at each replay, on the graph's
own inputs, so that the pipeline's plumbing (which inputs are bound per
call and per visit) is held against the eager loop image for image."""
import dataclasses
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.pipeline import graphs
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.serving.batcher import Batcher
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA = torch.device("cuda")
ENGAGED = dict(split=False, control=[], adapter=None, cache_interval=1, sag_scale=0.0,
               conds=None, tome_ratio=0.0, freeu=None, whole=True)


class ReplayingCapture:
    """A stand-in for :class:`graphs.CudaCapture`: the capture runs ``fn``
    once on the static inputs, and each replay runs it again on them into
    the output buffer."""

    def __init__(self):
        self.captures = 0

    def __call__(self, fn, inputs, share=None):
        self.captures += 1
        out = fn(inputs)
        return SimpleNamespace(replay=lambda: out.copy_(fn(inputs))), out


class RecordedCapture:
    """A stand-in whose replay runs nothing, as a real graph runs no host
    code."""

    def __call__(self, fn, inputs, share=None):
        return SimpleNamespace(replay=lambda: None), fn(inputs)


@pytest.fixture(scope="module")
def pipe():
    return PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, seed=5)


@pytest.fixture
def graphed(pipe, monkeypatch):
    """``pipe`` with the rule read as on the card and the replaying
    stand-in; the eager graphs put back after the test."""
    rule = graphs.engages
    monkeypatch.setattr(graphs, "engages", lambda device, **kw: rule(CUDA, **kw))
    eager = pipe.unet_graphs
    pipe.unet_graphs = graphs.VisitGraphs(pipe.device, capture=ReplayingCapture())
    yield pipe
    pipe.unet_graphs = eager


def _req(prompt, seed, split=32):
    cm = np.zeros((64, 64, 3), np.uint8)
    cm[:, :split] = (255, 0, 0)
    cm[:, split:] = (0, 0, 255)
    return dict(prompt=prompt, color_map_image=cm, seed=seed,
                color_context={(255, 0, 0): "cat,0.8", (0, 0, 255): "dog,0.4"})


def _batch(pipe, reqs, steps=3):
    return pipe.generate_batch(reqs, num_inference_steps=steps, output_type="np")


def _latents(pipe, reqs, steps=3):
    """A group's final latents: its ``denoise``'s return."""
    seen, denoise = [], pipe.denoise

    def record(*args, **kwargs):
        seen.append(denoise(*args, **kwargs))
        return seen[-1]

    pipe.denoise = record
    try:
        _batch(pipe, reqs, steps)
    finally:
        del pipe.denoise
    return seen[-1]


def _lora(pipe, value):
    """A rank-2 kohya LoRA on the UNet's first ``attn2.to_k``."""
    name = next(k for k in pipe.unet.state_dict() if k.endswith("attn2.to_k.weight"))
    out_dim, in_dim = pipe.unet.state_dict()[name].shape
    prefix = "lora_unet_" + name[:-len(".weight")].replace(".", "_")
    return {f"{prefix}.lora_down.weight": torch.full((2, in_dim), value),
            f"{prefix}.lora_up.weight": torch.full((out_dim, 2), value)}


# -- the rule -----------------------------------------------------------------------


@pytest.mark.parametrize("change, engaged", [
    ({}, True),
    ({"split": True}, False),
    ({"control": [("net", "hint", 1.0)]}, False),
    ({"adapter": [torch.zeros(1)]}, False),
    ({"cache_interval": 3}, False),
    ({"sag_scale": 0.75}, False),
    ({"conds": {0: None}}, False),
    ({"tome_ratio": 0.5}, False),
    ({"freeu": (1.5, 1.6, 0.9, 0.2)}, False),
    ({"whole": False}, False),
    ({"device": torch.device("cpu")}, False),
    ({"grad": True}, False),
])
def test_the_rule_engages_only_the_batched_plain_call_on_the_card(change, engaged):
    """Graphs on CUDA outside autograd on the batched CFG path; each of
    ControlNet, T2I, DeepCache, SAG, prompt editing, ToMe, FreeU, a mesh,
    split CFG, the CPU and grad mode keeps the eager loop."""
    kw = {**ENGAGED, **{k: v for k, v in change.items() if k not in ("device", "grad")}}
    with torch.set_grad_enabled(change.get("grad", False)):
        assert graphs.engages(change.get("device", CUDA), **kw) is engaged


# -- the signature ------------------------------------------------------------------


def test_the_signature_covers_what_a_capture_bakes_in(pipe):
    """Shapes, dtypes, the pyramid's keys, the weight function, the IP
    scale, the module and the weights' generation each give another key;
    equal inputs give the same one."""
    wf = WeightFunction()
    x = {"lat": torch.zeros(4, 4, 8, 8), "text": torch.zeros(4, 77, 32),
         "w64": torch.zeros(4, 64, 77), "t": torch.zeros(()), "sigma": torch.zeros(())}

    def key(inputs=x, unet=pipe.unet, generation=0, weight_fn=wf, ip_scale=None):
        return graphs.signature(unet, generation, inputs, weight_fn, ip_scale)

    assert key() == key(inputs={k: v.clone() for k, v in x.items()})
    others = [
        key(inputs={**x, "lat": torch.zeros(2, 4, 8, 8)}),
        key(inputs={**x, "lat": torch.zeros(4, 4, 16, 8)}),
        key(inputs={**x, "text": torch.zeros(4, 154, 32)}),
        key(inputs={**x, "text": torch.zeros(4, 77, 32, dtype=torch.bfloat16)}),
        key(inputs={**{k: v for k, v in x.items() if k != "w64"},
                    "w16": torch.zeros(4, 16, 77)}),
        key(inputs={**x, "ip": torch.zeros(4, 4, 32)}),
        key(weight_fn=dataclasses.replace(wf, scale=0.2)),
        key(weight_fn=dataclasses.replace(wf, sigma_mode="one")),
        key(weight_fn=dataclasses.replace(wf, reduce_mode="std")),
        key(ip_scale=0.5),
        key(generation=1),
        key(unet=pipe.vae),
    ]
    assert len({key(), *others}) == len(others) + 1


def test_weight_changes_drop_the_graphs(pipe):
    """``_place`` (a ControlNet load) and a LoRA merge and restore bump the
    weights' generation and drop every graph and seen signature."""
    g = pipe.unet_graphs
    lora = _lora(pipe, 0.01)
    seen = []
    for change in (lambda: pipe.load_lora(lora), pipe.unload_loras,
                   lambda: pipe.load_controlnet(seed=1)):
        g._seen.add("a signature")
        g._graphs["a signature"] = None
        before = g.generation
        change()
        seen.append(g.generation - before)
        assert not g._graphs and not g._seen
    pipe.controlnets = []
    assert all(n >= 1 for n in seen)


# -- launch counts ------------------------------------------------------------------


@pytest.mark.parametrize("replays", [0, 1, 29])
def test_launch_counts_after_capture_and_replays_are_the_visits_run(replays, monkeypatch):
    """A capture runs the wrappers' host code and no kernel: the counters
    are put back, and the capture's replay and every later one add one
    visit's launches. After one eager visit, the capture and N replays,
    every ``.launches`` reads N + 2 visits' worth."""
    per_visit = {c: 3 + i for i, c in enumerate(graphs.LAUNCH_COUNTERS)}
    for c in graphs.LAUNCH_COUNTERS:
        monkeypatch.setattr(c, "launches", 100)

    def visit(x):  # the wrappers' host code: each counts its launches
        for c, n in per_visit.items():
            c.launches += n
        return x["lat"] * 2.0

    g = graphs.VisitGraphs(torch.device("cpu"), capture=RecordedCapture())
    call = {"text": torch.ones(2, 3)}
    s = g.session(torch.nn.Linear(1, 1), visit, call, {"lat": torch.ones(2)}, None, None)
    for i in range(replays + 2):
        out = s.visit({"lat": torch.full((2,), float(i))})
        if i == 0:
            assert torch.equal(out, torch.zeros(2))  # eager: the visit's own value
    assert g.counts == {"eager": 1, "captured": 1, "replayed": replays}
    assert g.visits() == (replays + 2, replays + 1)
    for c, n in per_visit.items():
        assert c.launches == 100 + (replays + 2) * n, c.__name__


def test_a_failed_capture_puts_the_counters_back(monkeypatch):
    """A capture that raises leaves the counts as they were, and raises."""
    monkeypatch.setattr(graphs.fused_pww_reduce, "launches", 7)

    def visit(x):
        graphs.fused_pww_reduce.launches += 15
        if x["lat"].sum() > 0:
            raise RuntimeError("operation not permitted when stream is capturing")
        return x["lat"]

    g = graphs.VisitGraphs(torch.device("cpu"), capture=RecordedCapture())
    s = g.session(torch.nn.Linear(1, 1), visit, {}, {"lat": torch.zeros(2)}, None, None)
    s.visit({"lat": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="capturing"):
        s.visit({"lat": torch.ones(2)})
    assert graphs.fused_pww_reduce.launches == 7 + 15


def test_a_capture_joins_the_pool_of_a_live_graph():
    """The first capture starts a pool; a capture while a graph is held
    shares that graph's pool; after a weight change drops every graph the
    next capture starts a pool again."""
    shares = []

    def capture(fn, inputs, share=None):
        shares.append(share)
        return SimpleNamespace(replay=lambda: None), fn(inputs)

    g = graphs.VisitGraphs(torch.device("cpu"), capture=capture)
    unet = torch.nn.Linear(1, 1)

    def visits(rows, n=2):
        s = g.session(unet, lambda x: x["lat"] + 1.0, {}, {"lat": torch.zeros(rows)}, None,
                      None)
        for _ in range(n):
            s.visit({"lat": torch.zeros(rows)})

    visits(2)
    visits(4)
    first = g._graphs[next(iter(g._graphs))].graph
    g.invalidate()
    visits(2)
    assert shares == [None, first, None]


# -- the pipeline through the stand-in ----------------------------------------------


def test_replayed_groups_are_the_eager_groups(graphed, monkeypatch):
    """Two groups with other prompts, seeds and layouts, a LoRA merge and
    restore between: every group's final latents as the eager loop's, bit
    for bit; one eager visit and one capture per signature, the rest
    replays."""
    groups = [[_req("a cat and a dog", 1), _req("a dog and a cat", 2, 16)],
              [_req("a red cat near a dog", 3, 40), _req("a cat", 4, 24)]]
    eager = graphs.VisitGraphs(graphed.device)
    g = graphed.unet_graphs
    got = [_latents(graphed, grp) for grp in groups]
    assert g.counts == {"eager": 1, "captured": 1, "replayed": 4}
    lora = _lora(graphed, 0.05)
    graphed.load_lora(lora)
    got_lora = _latents(graphed, groups[1])
    graphed.unload_loras()
    got_back = _latents(graphed, groups[0])
    assert g._capture.captures == 3  # again after each weight change
    monkeypatch.setattr(graphs, "engages", lambda device, **kw: False)
    graphed.unet_graphs = eager
    want = [_latents(graphed, grp) for grp in groups]
    graphed.load_lora(lora)
    want_lora = _latents(graphed, groups[1])
    graphed.unload_loras()
    for a, b in zip(got + [got_lora, got_back], want + [want_lora, want[0]]):
        assert torch.equal(a, b)
    assert not torch.equal(got_lora, want[1])  # the merge reached the replays
    assert eager.counts["eager"] == 3 * 3 and eager.visits()[1] == 0


def test_the_pyramid_map_joins_only_where_a_level_misses_it(graphed):
    """A call whose every level is a pyramid key binds no full-resolution
    map; drop a level and the map is bound, and the images still match."""
    req = _req("a cat and a dog", 7)
    enc = graphed.encode_inputs(req["prompt"], req["color_map_image"], req["color_context"])
    lat = torch.zeros(2, 4, 8, 8)
    visit = {"lat": lat, "t": torch.zeros(()), "sigma": torch.zeros(())}
    s = graphed._visit_session(enc.text_states, enc.pww, None, None, visit)
    assert "orig" not in s.call_inputs and "w64" in s.call_inputs
    missing = dataclasses.replace(enc.pww, weights={k: v for k, v in enc.pww.weights.items()
                                                    if k != 16})
    s = graphed._visit_session(enc.text_states, missing, None, None, visit)
    assert "orig" in s.call_inputs
    run = s.fn({**s.call_inputs, **visit})
    want = graphed.unet(lat, visit["t"], enc.text_states, missing.with_sigma(visit["sigma"]))
    torch.testing.assert_close(run, want, rtol=0, atol=0)


def test_calls_outside_the_rule_count_eager_visits(graphed):
    """DeepCache keeps the eager loop: every visit counts as eager."""
    g = graphed.unet_graphs
    graphed.generate_batch([_req("a cat", 1)], num_inference_steps=4, cache_interval=2,
                           output_type="np")
    assert g.counts == {"eager": 4, "captured": 0, "replayed": 0}


# -- the Batcher's counters and their reader ------------------------------------------


def _graph_share():
    path = os.path.join(REPO, "portbench", "metrics", "pipeline.graph_share.serve.py")
    spec = importlib.util.spec_from_file_location("graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_batcher_counts_unet_and_graph_visits(graphed):
    """The keys exist from the constructor; each group adds the pipeline's
    visits and those replayed, and the reader makes a share of them."""
    b = Batcher(graphed, max_batch=2, max_wait_ms=200)
    try:
        assert b.stats["unet_visits"] == 0 and b.stats["graph_visits"] == 0
        futures = [b.submit(dict(_req(f"a cat {i}", i), num_inference_steps=3))
                   for i in range(4)]
        for f in futures:
            f.result(timeout=300)
        stats = dict(b.stats)
    finally:
        b.close()
    assert stats["unet_visits"] == 3 * stats["batches"]
    assert stats["graph_visits"] == stats["unet_visits"] - graphed.unet_graphs.counts["eager"]
    share = _graph_share()(SimpleNamespace(batcher_stats=stats))
    assert share == pytest.approx(100.0 * stats["graph_visits"] / stats["unet_visits"])


@pytest.mark.parametrize("stats, share", [
    ({"batches": 4, "unet_visits": 120, "graph_visits": 118}, 100.0 * 118 / 120),
    ({"batches": 4, "unet_visits": 120, "graph_visits": 120}, 100.0),
    ({"batches": 4, "unet_visits": 120, "graph_visits": 0}, 0.0),
    ({"batches": 4, "batched_requests": 32}, None),  # a program without the counters
    ({"batches": 0, "unet_visits": 0, "graph_visits": 0}, None),
    (None, None),
])
def test_the_graph_share_reader(stats, share):
    got = _graph_share()(SimpleNamespace(batcher_stats=stats))
    assert got == (None if share is None else pytest.approx(share))
