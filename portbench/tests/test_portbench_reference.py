"""The reference against the port at tiny sizes on the CPU, and its counts."""
import json

import numpy as np
import pytest
import torch

from portbench import check, harness, loadgen, manifest, weights
from portbench.reference import jaxnoise
from portbench.reference.lowp import set_fp8
from portbench.reference.models import build
from portbench.roofline import flops
from portbench.wordtok import WordTokenizer

from .conftest import tiny_config

MIX = {"entry": "generate", "sizes": [[64, 64]], "regions": [2, 4], "prompt_words": [8, 30],
       "strength": [0.3, 1.0], "steps": 4, "guidance_scale": 7.5,
       "_vocab": json.load(open("portbench/data/words.json"))}


def both(kind, seed=11):
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline

    from portbench import modelcfg

    cfg = tiny_config(kind)
    _, params = weights.draw(weights.shapes_of(build(cfg)), seed, "cpu", torch.float32)
    tok, tok2 = WordTokenizer(), (WordTokenizer(0) if "clip2" in cfg else None)
    pipe = PwwPipeline(modelcfg.program_config(cfg), params=params, tokenizer=tok,
                       tokenizer_2=tok2, device="cpu", dtype=torch.float32)
    return pipe, check.build_reference(cfg, params, "cpu", tok, tok2)


@pytest.mark.parametrize("kind", ["sd", "xl"])
def test_txt2img_matches_the_port(kind):
    pipe, ref = both(kind)
    reqs = [loadgen.make_request(MIX, 3, c, 0) for c in range(2)]
    got = np.stack([pipe.generate(**r, output_type="np")[0] for r in reqs])
    want = ref.txt2img(reqs, 4, 7.5)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert got.std() > 20  # the drawn weights give images with contrast
    if kind == "sd":
        batch = pipe.generate_batch(reqs, num_inference_steps=4, output_type="np")
        assert np.abs(batch.astype(int) - want).max() <= 1


def test_jax_noise_matches_the_ports_draw():
    from pww_tpu_torch.utils import jax_random

    for seed in (0, 7, 2 ** 31 + 3):
        want = jax_random.normal(jax_random.PRNGKey(seed), (1, 8, 8, 4))
        assert np.array_equal(jaxnoise.normal(seed, (1, 8, 8, 4)), want)
    # jax's own answers for PRNGKey(0) (jax 0.9.0, partitionable threefry)
    assert np.allclose(jaxnoise.normal(0, (4,)),
                       [1.622642159461975, 2.0252647399902344, -0.4335944354534149,
                        -0.07861734926700592], atol=1e-6)


def test_the_fp8_control_fails_the_limit_at_a_tiny_size():
    """The control: the reference one precision step below bf16, judged by
    the harness's own decision, is not correct under any cell's limit;
    float32 against itself reads 0 and is."""
    _, ref = both("sd", seed=5)
    reqs = [loadgen.make_request(MIX, 9, c, 0) for c in range(2)]
    want = ref.txt2img(reqs, 4, 7.5)
    assert check.rel_l2(ref.txt2img(reqs, 4, 7.5)[0], want[0]) == 0.0
    for m in ref.m.values():
        set_fp8(m, True)
    got = ref.txt2img(reqs, 4, 7.5)
    for w in manifest.load(".")["workloads"]:
        limit = harness.cell_settings(w["name"])["check"]["image_rel_l2"]
        assert check.judge(list(zip(want, want)), 0, limit) == (
            {"image_rel_l2": {"value": 0.0, "limit": limit},
             "failed": {"value": 0, "limit": 0}}, True)
        numbers, correct = check.judge(list(zip(got, want)), 0, limit)
        assert not correct and numbers["image_rel_l2"]["value"] > limit


@pytest.mark.parametrize("name, hw, visit, decode", [
    ("sd15", 64, 1.607e12, 2.515e12), ("sd15", 128, 9.348e12, 10.470e12),
    ("sdxl_base", 128, 13.522e12, 10.470e12)])
def test_flop_counts(name, hw, visit, decode):
    c = flops.counts(json.load(open(f"portbench/configs/{name}.json")), hw, hw)
    assert c["unet_visit"] == pytest.approx(visit, rel=1e-3)
    assert c["decode"] == pytest.approx(decode, rel=1e-3)


def test_weights_draw_repeats_and_scales():
    cfg = tiny_config("sd")
    shapes = weights.shapes_of(build(cfg))
    _, a = weights.draw(shapes, 3, "cpu", torch.float32)
    _, b = weights.draw(shapes, 3, "cpu", torch.float32)
    assert all(torch.equal(a[p][k], b[p][k]) for p in a for k in a[p])
    norm = a["unet"]["conv_norm_out.weight"]
    assert (norm - 1).abs().max() < 0.2
    conv = a["unet"]["conv_in.weight"]
    assert 0.5 < float(conv.std() * (conv[0].numel() ** 0.5)) < 2.0
