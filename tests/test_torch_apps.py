"""The port's figure utility, the apps' helpers and callbacks, the runners
and the examples against the JAX package's (CPU, f32).

* ``annotate_color_map`` and ``fig_from_settings`` pixel-equal to
  ``pww_tpu.utils.fig``'s;
* ``pww_tpu_torch.apps.gradio_helpers`` equal to ``apps/gradio_helpers.py``
  on images whose colors have no ties in their pixel counts (the order of
  tied colors is the sort's);
* ``run_pww`` and ``run_pww_inpaint`` on the tiny configs against the JAX
  apps' callbacks, whose ``paint_with_words`` are made to draw torch noise
  (else they draw ``jax.random`` noise, ROADMAP C.5) and whose inpainting
  takes the VAE posterior's mean: images within one uint8 level, on at
  most 1% of the pixels (rounding at .5 boundaries of final latents that
  agree within 2e-5·max);
* the runners' and examples' ``main`` on the tiny config (the training
  example at 2 steps); ``build_ui`` without gradio.
"""
import functools
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import gradio_helpers as jax_helpers  # noqa: E402
import gradio_pww as jax_gradio_pww  # noqa: E402
import gradio_pww_inpaint as jax_gradio_inpaint  # noqa: E402
from pww_tpu.config import SDModelConfig as JaxSDModelConfig  # noqa: E402
from pww_tpu.utils import fig as jax_fig  # noqa: E402
from pww_tpu_torch.apps import (gradio_helpers, gradio_pww, gradio_pww_inpaint,  # noqa: E402
                                runner, runner_inpaint)
from pww_tpu_torch.config import SDModelConfig  # noqa: E402
from pww_tpu_torch.examples import (advanced_generation, controlnet_pww,  # noqa: E402
                                    textual_inversion_pww, train_textual_inversion_pww)
from pww_tpu_torch.utils import fig  # noqa: E402
from torch_port_cases import pipeline_pair, few_torch_threads  # noqa: E402,F401


def sketch(size=96):
    """Three colors with distinct counts, a near-red pixel and a rare one."""
    img = np.zeros((size, size, 3), np.uint8)
    img[: size // 2] = (255, 0, 0)
    img[size // 2:, : size // 3] = (0, 0, 255)
    img[size // 2:, size // 3:] = (30, 200, 40)
    img[5, 5] = (252, 2, 1)
    img[0, 0] = (1, 2, 3)
    return img


SETTINGS = {"color_context": {(255, 0, 0): "a red cat,1.0", (0, 0, 255): "dog,0.5,7",
                              (30, 200, 40): "grass"},
            "input_prompt": "a red cat and a dog on the grass, in a long prompt that wraps "
                            "over more than one line of the figure's caption"}


@pytest.mark.parametrize("captions", [None, ["first", "second"]])
def test_figures_are_pixel_equal_to_jax(captions):
    cm = sketch()
    a = fig.annotate_color_map(Image.fromarray(cm), SETTINGS["color_context"])
    b = jax_fig.annotate_color_map(Image.fromarray(cm), SETTINGS["color_context"])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), cm)  # the labels were drawn
    images = [Image.fromarray(np.full((64, 64, 3), v, np.uint8)) for v in (90, 180)]
    settings = {**SETTINGS, "color_map_image": cm}
    got = fig.fig_from_settings(settings, images, optional_captions=captions)
    want = jax_fig.fig_from_settings(settings, images, optional_captions=captions)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_helpers_equal_the_jax_apps():
    img = sketch()
    assert gradio_helpers.unique_colors(img) == jax_helpers.unique_colors(img)
    assert len(gradio_helpers.unique_colors(img)) == 3
    for color in ((255, 0, 0), (30, 200, 40)):
        np.testing.assert_array_equal(gradio_helpers.get_color_mask(color, img),
                                      jax_helpers.get_color_mask(color, img))
        np.testing.assert_array_equal(gradio_helpers.color_mask_preview(color, img),
                                      jax_helpers.color_mask_preview(color, img))
    assert gradio_helpers.extract_color_textboxes(img) == \
        jax_helpers.extract_color_textboxes(img)
    for mine, theirs in zip(gradio_helpers.extract_color_panels(img, 4),
                            jax_helpers.extract_color_panels(img, 4)):
        assert len(mine) == len(theirs) == 4
        for m, t in zip(mine, theirs):
            np.testing.assert_array_equal(np.asarray(m, dtype=object), np.asarray(t, dtype=object))
    panels = (["(255, 0, 0)", "", "(0, 0, 255)"], ["cat", "", "dog"], ["1.0", "", "0.5"],
              ["-1", "", "3"])
    text = gradio_helpers.collect_color_panels(*panels)
    assert text == jax_helpers.collect_color_panels(*panels)
    assert gradio_helpers.parse_color_content(text) == jax_helpers.parse_color_content(text)
    entries = gradio_helpers.extract_color_textboxes(img)
    assert gradio_helpers.collect_color_content(entries) == \
        jax_helpers.collect_color_content(entries)
    assert gradio_helpers.derive_sample_seeds(7, 4) == jax_helpers.derive_sample_seeds(7, 4)


def _as_arrays(images):
    return np.stack([np.asarray(im) for im in images]).astype(int)


def assert_images_close(got, want):
    diff = np.abs(_as_arrays(got) - _as_arrays(want))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2


CONTENT = "{(255, 0, 0): 'cat,1.5', (0, 0, 255): 'dog,0.5'}"


def test_run_pww_matches_the_jax_callback(monkeypatch):
    jp, tp = pipeline_pair(seed=0)
    monkeypatch.setattr(jax_gradio_pww, "_PIPE", jp)
    monkeypatch.setattr(gradio_pww, "_PIPE", tp)
    monkeypatch.setattr(jax_gradio_pww, "paint_with_words",
                        functools.partial(jax_gradio_pww.paint_with_words, noise_mode="torch"))
    monkeypatch.setattr(gradio_pww, "paint_with_words",
                        functools.partial(gradio_pww.paint_with_words, noise_mode="torch"))
    args = (sketch(64), CONTENT, "a cat and a dog", "ugly", None, 64, 64, 2, 2, 7.5, 5, 0.5)
    want = jax_gradio_pww.run_pww(*args)
    got = gradio_pww.run_pww(*args, device="cpu")
    assert len(got) == len(want) == 2 and got[0].size == (64, 64)
    assert_images_close(got, want)
    assert not np.array_equal(np.asarray(got[0]), np.asarray(got[1]))  # two seeds
    with pytest.raises(ValueError, match="color map"):
        gradio_pww.run_pww(None, *args[1:], device="cpu")


def test_run_pww_inpaint_matches_the_jax_callback(monkeypatch):
    jp, tp = pipeline_pair(JaxSDModelConfig.tiny(in_channels=9), SDModelConfig.tiny(in_channels=9))
    for p in (jp, tp):
        monkeypatch.setattr(p, "generate", functools.partial(p.generate, vae_sample_mode="mean"))
    monkeypatch.setattr(jax_gradio_inpaint, "_PIPE", jp)
    monkeypatch.setattr(gradio_pww_inpaint, "_PIPE", tp)
    monkeypatch.setattr(jax_gradio_inpaint, "paint_with_words_inpaint", functools.partial(
        jax_gradio_inpaint.paint_with_words_inpaint, noise_mode="torch"))
    monkeypatch.setattr(gradio_pww_inpaint, "paint_with_words_inpaint", functools.partial(
        gradio_pww_inpaint.paint_with_words_inpaint, noise_mode="torch"))
    init = np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[16:48, 16:48] = 255
    args = (sketch(64), CONTENT, "a cat and a dog", "", {"image": init, "mask": mask},
            64, 64, 1, 2, 7.5, 3, 1.0)
    want = jax_gradio_inpaint.run_pww_inpaint(*args)
    got = gradio_pww_inpaint.run_pww_inpaint(*args, device="cpu")
    assert len(got) == 1 and got[0].size == (64, 64)
    assert_images_close(got, want)
    with pytest.raises(ValueError, match="init image"):
        gradio_pww_inpaint.run_pww_inpaint(sketch(64), CONTENT, "", "", None, 64, 64, 1, 2,
                                           7.5, 0, 1.0, device="cpu")


def test_runners_write_their_images(tmp_path):
    out = str(tmp_path / "out")
    assert runner.main(["--device", "cpu", "--steps", "2", "--only", "aurora_1",
                        "--out", out]) == 0
    assert runner_inpaint.main(["--device", "cpu", "--out", out]) == 0
    files = sorted(os.listdir(out))
    assert files == ["fig_aurora_1.png", "output_aurora_1.png", "output_inpaint_fox.png",
                     "output_inpaint_moon.png"]
    assert Image.open(os.path.join(out, "output_aurora_1.png")).size == (128, 128)
    assert Image.open(os.path.join(out, "fig_aurora_1.png")).width == 256
    # the aurora example's five regions as five bands of its map
    cm = runner.example_color_map(runner.EXAMPLES[0], 128)
    assert sorted(map(tuple, np.unique(cm.reshape(-1, 3), axis=0))) == \
        sorted(runner.EXAMPLES[0]["color_context"])


def test_examples_run(tmp_path):
    assert textual_inversion_pww.main(["--device", "cpu",
                                       "--out", str(tmp_path / "ti.png")]) == 0
    assert controlnet_pww.main(["--device", "cpu", "--out", str(tmp_path / "cn.png")]) == 0
    assert advanced_generation.main(["--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    assert train_textual_inversion_pww.main([
        "--device", "cpu", "--steps", "2", "--out", str(tmp_path / "learned_embeds.bin"),
        "--sample", str(tmp_path / "ti_sample.png")]) == 0
    assert len(os.listdir(tmp_path)) == 9


def test_build_ui_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # `import gradio` raises ImportError
    for app in (gradio_pww, gradio_pww_inpaint):
        with pytest.raises(ImportError, match="gradio"):
            app.build_ui()
