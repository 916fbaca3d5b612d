"""The port's LMS scheduler and txt2img pipeline against the JAX package's,
and the port's import boundary (CPU, f32 on both sides)."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SchedulerConfig as JSchedulerConfig
from pww_tpu.pipeline.pipeline import run_decode
from pww_tpu.schedulers.schedules import make_scheduler as jax_make_scheduler
from pww_tpu_torch.pipeline.facade import paint_with_words
from pww_tpu_torch.pipeline.pipeline import resolve_device
from pww_tpu_torch.schedulers.schedules import make_scheduler
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("steps", [3, 30])
def test_lms_schedule_matches_jax(steps):
    js = jax_make_scheduler("lms", JSchedulerConfig()).set_timesteps(steps)
    ts = make_scheduler("lms").set_timesteps(steps)
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.sigmas.numpy(), np.asarray(js.sigmas))
    np.testing.assert_array_equal(ts.lms_coeffs, np.asarray(js.lms_coeffs))
    assert ts.init_noise_sigma == float(js.init_noise_sigma)


def test_lms_steps_match_jax_including_the_history_truncation():
    """Four steps from an empty (zero) history: steps 0-2 use 1-3
    derivatives (diffusers' zip truncation), step 3 the full order-4
    history; the history rows not yet filled stay zero."""
    js = jax_make_scheduler("lms", JSchedulerConfig()).set_timesteps(10)
    ts = make_scheduler("lms").set_timesteps(10)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    jx, jstate = jnp.asarray(x), js.init_state(x.shape, jnp.float32)
    tx, hist = torch.from_numpy(x), ts.init_state(x.shape)
    for i in range(4):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        np.testing.assert_allclose(
            ts.scale_model_input(tx, i).numpy(),
            np.asarray(js.scale_model_input(jx, i)), rtol=1e-6)
        jx, jstate = js.step(jnp.asarray(eps), i, jx, jstate)
        tx, hist = ts.step(torch.from_numpy(eps), i, tx, hist)
        assert int((hist.flatten(1).abs().sum(1) > 0).sum()) == min(i + 1, 4)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jstate), rtol=1e-6, atol=1e-6)


# The golden "tiny_txt2img_v1" case at 128 px: a regional seed on the blue
# region, 3 LMS steps, torch-mode noise.
KWARGS = dict(
    prompt="a cat and a dog", color_map_image=color_map(128),
    color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
    num_inference_steps=3, seed=0, noise_mode="torch",
)


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=0)


def test_tiny_txt2img_matches_live_jax_run(pair):
    """Final latents within f32 summation-order noise (relative to their
    max), and the uint8 image within one level on a small share of pixels
    (rounding at .5 boundaries)."""
    jp, tp = pair
    want = np.asarray(jp.generate(return_latents=True, **KWARGS))
    got = tp.generate(return_latents=True, **KWARGS)
    assert got.shape == want.shape == (1, 16, 16, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())

    want_img = np.asarray(run_decode(jp.vae, jp.params["vae"], jnp.asarray(want)))
    img = paint_with_words(
        color_context=KWARGS["color_context"], color_map_image=KWARGS["color_map_image"],
        input_prompt=KWARGS["prompt"], num_inference_steps=3, seed=0, noise_mode="torch",
        device="cpu", preloaded_utils=tp, output_type="np",
    )
    assert img.shape == (1, 128, 128, 3) and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - want_img.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2


def test_num_samples_rows_follow_the_single_sample_noise_stream(pair):
    """num_samples=2 draws (2, C, h, w) from the same seeded stream, so row 0
    is the single-sample result and row 1 differs."""
    _, tp = pair
    one = tp.generate(return_latents=True, **KWARGS)
    two = tp.generate(return_latents=True, num_samples=2, **KWARGS)
    assert two.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(two[:1], one, rtol=1e-5, atol=1e-5 * np.abs(one).max())
    assert not np.allclose(two[0], two[1])


def test_txt2img_bias_and_seed_change_the_result(pair):
    _, tp = pair
    base = tp.generate(return_latents=True, **KWARGS)
    no_bias = tp.generate(return_latents=True, **{
        **KWARGS, "color_context": {(255, 0, 0): "cat,0.0", (0, 0, 255): "dog,0.0,7"}})
    other_seed = tp.generate(return_latents=True, **{**KWARGS, "seed": 1})
    assert np.isfinite(base).all()
    assert not np.allclose(base, no_bias) and not np.allclose(base, other_seed)
    pil = tp.generate(**KWARGS)
    assert pil.size == (128, 128)


def test_unported_options_raise(pair):
    """What the port does not have: hub downloads; a noise mode other than
    "jax" (the default; tests/test_torch_jax_random.py) and "torch"
    raises ValueError; and an IP-Adapter image without an adapter attached, a ValueError as in
    the JAX pipeline, whose ``ip_adapter_scale`` alone changes nothing
    (the IP-Adapter came with tests/test_torch_ip_adapter.py; the LCM scheduler came with the sampling extras,
    tests/test_torch_lcm_hires.py; per-step callbacks came with the
    serving slice, tests/test_torch_batch.py; img2img, inpaint
    and custom weight functions came with the second slice,
    tests/test_torch_img2img_inpaint.py; the other schedulers and local
    checkpoint directories are in tests/test_torch_schedulers.py and
    tests/test_torch_loader.py; ControlNet and the T2I-Adapter in
    tests/test_torch_controlnet.py and tests/test_torch_t2i_adapter.py;
    latent-space img2img, ``init_latents`` with ``denoising_start``, in
    tests/test_torch_sdxl.py)."""
    _, tp = pair
    with pytest.raises(ValueError, match="load_ip_adapter"):
        paint_with_words(preloaded_utils=tp, device="cpu",
                         ip_adapter_image=np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="noise_mode"):
        tp.generate(**{**KWARGS, "noise_mode": "numpy"})
    kw = {**KWARGS, "num_inference_steps": 1, "return_latents": True}
    np.testing.assert_array_equal(tp.generate(**kw, ip_adapter_scale=0.5), tp.generate(**kw))
    with pytest.raises(NotImplementedError):
        paint_with_words(preloaded_utils=tp, device="cpu", model_token="token")
    with pytest.raises(FileNotFoundError):
        paint_with_words(device="cpu", hf_model_path="runwayml/stable-diffusion-v1-5")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port loads neither JAX nor the JAX
    package, nor the packages the card's machine lacks (``msgpack``,
    ``safetensors``, ``ml_dtypes``, ``gradio``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pww_tpu_torch\n"
        "for m in pkgutil.walk_packages(pww_tpu_torch.__path__, 'pww_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "banned = ('jax', 'flax', 'pww_tpu', 'msgpack', 'safetensors', 'ml_dtypes', 'gradio')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "n = sum(m.startswith('pww_tpu_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_port_exports_the_jax_packages_public_names():
    """Every public name of ``pww_tpu/__init__.py`` but the two that wait
    for their ROADMAP item: ``MeshConfig`` and ``make_mesh`` (A.20,
    multi-GPU). ``train_textual_inversion`` (A.18, training) came with the
    training slice."""
    import pww_tpu
    import pww_tpu_torch

    assert pww_tpu_torch.train_textual_inversion.__module__ == \
        "pww_tpu_torch.training.textual_inversion"
    waiting = {"MeshConfig": "A.20", "make_mesh": "A.20"}
    public = {n for n in vars(pww_tpu) if not n.startswith("_")
              and not isinstance(getattr(pww_tpu, n), type(pww_tpu))}
    assert set(waiting) <= public
    missing = sorted(n for n in public - set(waiting) if not hasattr(pww_tpu_torch, n))
    assert not missing, missing
    assert not any(hasattr(pww_tpu_torch, n) for n in waiting)
    doc = pww_tpu_torch.__doc__
    assert all(n in doc and item in doc for n, item in waiting.items())
    assert pww_tpu_torch.PwwPipeline.__module__ == "pww_tpu_torch.pipeline.pipeline"
