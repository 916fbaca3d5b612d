"""The generator: the same seed gives the same requests, whatever the timing."""
import numpy as np
import pytest

from portbench import loadgen


MIXES = ("closed16_b8_512",)


@pytest.mark.parametrize("name", MIXES)
def test_requests_repeat_per_seed(name):
    mix = loadgen.load_mix(name)
    seed = 2 ** 31 + 99
    for c, k in ((0, 0), (3, 7), (15, 40)):
        a, b = loadgen.make_request(mix, seed, c, k), loadgen.make_request(mix, seed, c, k)
        assert a["prompt"] == b["prompt"] and a["seed"] == b["seed"]
        assert np.array_equal(a["color_map_image"], b["color_map_image"])
        assert a["color_context"] == b["color_context"]
    other = loadgen.make_request(mix, seed + 1, 0, 0)
    assert other["prompt"] != loadgen.make_request(mix, seed, 0, 0)["prompt"]


@pytest.mark.parametrize("name", MIXES)
def test_every_region_is_in_its_map_and_its_label_in_the_prompt(name):
    mix = loadgen.load_mix(name)
    for k in range(50):
        r = loadgen.make_request(mix, 12345, 0, k)
        cm = r["color_map_image"]
        assert list(cm.shape[:2]) in mix["sizes"]
        assert mix["regions"][0] <= len(r["color_context"]) <= mix["regions"][1]
        words = r["prompt"].split()
        assert mix["prompt_words"][0] <= len(words) <= mix["prompt_words"][1]
        for color, ctx in r["color_context"].items():
            label, strength = ctx.rsplit(",", 1)
            assert label in words
            assert mix["strength"][0] <= float(strength) <= mix["strength"][1]
            assert (cm == np.asarray(color, np.uint8)).all(-1).any()
        assert r["num_inference_steps"] == mix["steps"]


def test_prompts_fit_one_window_of_77_tokens():
    from portbench.wordtok import WordTokenizer

    mix = loadgen.load_mix("closed16_b8_512")
    tok = WordTokenizer()
    for k in range(50):
        assert len(tok.tokenize(loadgen.make_request(mix, 7, 1, k)["prompt"])) <= 75


def test_a_loop_other_than_closed_is_refused(tmp_path):
    import json
    import os
    import shutil

    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(loadgen.HERE, "data"), pb / "data")
    (pb / "traffic").mkdir()
    mix = json.load(open(os.path.join(loadgen.HERE, "traffic", "closed16_b8_512.json")))
    mix["loop"] = {"kind": "open", "rate": 2.0}
    (pb / "traffic" / "open.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="closed"):
        loadgen.load_mix("open", str(pb))
