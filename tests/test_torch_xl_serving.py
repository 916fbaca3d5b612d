"""SDXL-base served in groups: the tiny two-tower config through ``Batcher``
against the benchmark's plain float32 reference, the group text encode for
two towers (``_prewarm_text_cache``) against each request's own encode, and
the phases a profiled ``generate_batch`` records (CPU, f32)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from portbench import check, loadgen, modelcfg, weights
from portbench.reference.models import build
from portbench.wordtok import WordTokenizer
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.serving.batcher import Batcher
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def tiny_xl_config() -> dict:
    """``SDModelConfig.tiny_xl()`` as a benchmark configuration dict; the
    towers take the benchmark tokenizer's ids (vocabulary 49408, EOS 49407)."""
    c = dataclasses.asdict(SDModelConfig.tiny_xl())
    cfg = {k: c[k] for k in ("clip", "clip2", "unet", "vae", "scheduler")}
    cfg["clip"]["vocab_size"] = 49408
    cfg["clip2"].update(vocab_size=49408, eos_token_id=49407)
    cfg.update(force_zeros_for_empty_prompt=True, dtype="float32")
    return cfg


@pytest.fixture(scope="module")
def served():
    """(config, drawn weights, tokenizers, pipeline with ``profile=True``)."""
    cfg = tiny_xl_config()
    _, params = weights.draw(weights.shapes_of(build(cfg)), 2 ** 31 + 5, "cpu", torch.float32)
    tok, tok2 = WordTokenizer(), WordTokenizer(pad_token_id=0)
    pipe = PwwPipeline(modelcfg.program_config(cfg), params=params, tokenizer=tok,
                       tokenizer_2=tok2, device="cpu", dtype=torch.float32, profile=True)
    return cfg, params, (tok, tok2), pipe


def mix_like_the_cell():
    """``closed8_b4_1024``'s mix at 64² and 3 steps."""
    mix = loadgen.load_mix("closed8_b4_1024", os.path.join(REPO, "portbench"))
    return dict(mix, sizes=[[64, 64]], steps=STEPS)


def requests(n, seed=2 ** 31 + 11):
    mix = mix_like_the_cell()
    return mix, [loadgen.make_request(mix, seed, c, 0) for c in range(n)]


def test_served_groups_match_the_reference(served):
    """Four requests through ``Batcher(max_batch=2)`` (two groups of 2, four
    UNet rows each) against the reference worked out alone from the same
    inputs and weights. Tolerance: every pixel within one uint8 level, on
    under 1% of them: both sides are f32 on the CPU but sum in other orders
    (batched GEMMs, the kernels' plain versions against the reference's own
    attention), so a value near a .5 boundary may round either way."""
    cfg, params, (tok, tok2), pipe = served
    mix, reqs = requests(4)
    pipe.invalidate_encode_caches()
    batcher = Batcher(pipe, max_batch=2, max_wait_ms=200)
    try:
        got = [np.asarray(f.result(timeout=600)) for f in [batcher.submit(r) for r in reqs]]
        stats = dict(batcher.stats)
    finally:
        batcher.close()
    assert stats["batched_requests"] == 4 and stats["batches"] == 2
    ref = check.build_reference(cfg, params, "cpu", tok, tok2)
    want = check.reference_images(ref, mix, reqs, 2)
    for g, w in zip(got, want):
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())
        assert g.std() > 20  # the drawn weights give images with contrast


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("n", [2, 3])
def test_group_encode_caches_each_requests_own_encode(served, n):
    """One call of each tower for the group's pairs (3 padded to 4), and
    each pair cached as its own encode would give it: the states and the
    pooled vector within 1e-5 relative (the same f32 towers on 2 rows
    against 2·K), the uncond row zero for an empty negative prompt."""
    *_, pipe = served
    _, reqs = requests(n)
    reqs[0]["negative_prompt"] = "blurry dark"
    calls = {"clip": [], "clip2": []}
    hooks = [getattr(pipe, t).register_forward_hook(
        lambda m, args, out, t=t: calls[t].append(args[0].shape[0])) for t in calls]
    try:
        pipe.invalidate_encode_caches()
        pipe._prewarm_text_cache(reqs)
    finally:
        for h in hooks:
            h.remove()
    rows = 2 * (1 << (n - 1).bit_length())
    assert calls == {"clip": [rows], "clip2": [rows]}
    warm = dict(pipe._text_cache)
    assert len(warm) == n
    pipe.invalidate_encode_caches()
    for r in reqs:
        neg = r.get("negative_prompt", "")
        states, pooled = warm[(r["prompt"], neg, False, 0, False)]
        alone = pipe.encode_inputs(r["prompt"], r["color_map_image"], r["color_context"],
                                  neg)
        assert states.shape == alone.text_states.shape and pooled.shape == alone.pooled.shape
        for row in (0, 1):
            if neg == "" and row == 0:
                assert not states[0].any() and not pooled[0].any()
                assert not alone.text_states[0].any() and not alone.pooled[0].any()
                continue
            assert _rel(states[row], alone.text_states[row]) < 1e-5
            assert _rel(pooled[row], alone.pooled[row]) < 1e-5


def test_served_group_runs_each_tower_once(served):
    """A ``generate_batch`` group of 3 runs each tower once, on the padded
    8 rows: the per-request encodes all hit the cache."""
    *_, pipe = served
    _, reqs = requests(3, seed=2 ** 31 + 23)
    calls = {"clip": 0, "clip2": 0}
    hooks = [getattr(pipe, t).register_forward_hook(
        lambda m, args, out, t=t: calls.__setitem__(t, calls[t] + 1)) for t in calls]
    try:
        pipe.invalidate_encode_caches()
        pipe.generate_batch(reqs, num_inference_steps=1, output_type="np")
    finally:
        for h in hooks:
            h.remove()
    assert calls == {"clip": 1, "clip2": 1}


def test_refiner_keeps_the_per_request_encode():
    """The refiner's one projected tower is left to each request's encode."""
    pipe = PwwPipeline(SDModelConfig.tiny_xl_refiner(), device="cpu", dtype=torch.float32)
    pipe._prewarm_text_cache([{"prompt": "a cat"}, {"prompt": "a dog"}])
    assert not pipe._text_cache


def test_profiled_generate_batch_records_the_text_phase(served):
    *_, pipe = served
    _, reqs = requests(2, seed=2 ** 31 + 31)
    pipe.timers.times.clear()
    pipe.generate_batch(reqs, num_inference_steps=1, output_type="np")
    assert {k: len(v) for k, v in pipe.timers.times.items()} == {
        "text": 1, "encode": 1, "denoise": 1, "decode": 1}
    assert list(pipe.timers.times) == ["text", "encode", "denoise", "decode"]
    assert all(t >= 0.0 for v in pipe.timers.times.values() for t in v)
    pipe.generate(**reqs[0], output_type="np")  # generate records no "text" phase
    assert len(pipe.timers.times["text"]) == 1 and len(pipe.timers.times["encode"]) == 2
