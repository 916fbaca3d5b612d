"""The JAX package's committed goldens and its composition proof, run in
the port (CPU).

* The five golden cases (``tests/golden_cases.py``: txt2img, img2img with
  the VAE posterior sample, 9-channel inpaint, regional seeds with a blur
  region, SDXL) against the committed ``tests/golden/*.npy`` latents and
  ``_img`` images. The weights are the JAX package's ``init_params``
  (``PRNGKey(0)``) cast to bf16, bridged by ``params_from_jax``; the port
  runs in bf16 as the JAX pipeline that wrote the files did. The goldens
  hold bf16 numerics: the JAX package's own f32 run on the same weights
  lies 2.2e-2 (mean relative) from its txt2img golden, and the port's bf16
  run, which rounds at other points, 1.4e-2 to 3.2e-2 from the five. So the
  port is held to 5e-2 mean relative on the latents (a wrong noise stream,
  an f32 posterior draw for instance, lands near 1) and to a mean of 3
  levels on the uint8 images (1.3 to 2.0 seen). The JAX harness holds the
  JAX package to 1e-3 (``tests/test_fidelity_harness.py``), bit for bit
  its own rounding.
* The composition proof's four cases (``tests/test_composition_torch.py:
  483-536``): the reference's whole loop re-implemented in torch against
  the port's ``generate`` on the same synthetic checkpoint, f32, at that
  file's tolerances (latents atol 2e-3 rtol 1e-3; images ≤ 2 levels, mean
  < 0.05).

The JAX inits are compiled at XLA's lowest optimisation level (the same
parameters bit for bit, in about 20 s a config instead of 75 eagerly); the
9-channel config reuses the 4-channel one's text tower and VAE.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_cases import CASES
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.clip import CLIPTextEncoder
from pww_tpu.models.unet import UNet2DCondition
from pww_tpu.models.vae import AutoencoderKL
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.weights.bridge import params_from_jax
from test_composition_torch import (GUIDANCE, SIZE, STEPS, _color_map, _make_fixture,
                                    torch_reference_generate,
                                    torch_reference_generate_inpaint)
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LAT_TOL = 5e-2  # mean relative, bf16 against bf16 rounded elsewhere
IMG_TOL = 3.0  # mean uint8 levels
ALL_MODES = ["tiny_txt2img_v1", "tiny_img2img_v1", "tiny_inpaint_v1",
             "tiny_regional_blur_v1", "tiny_xl_v1"]
LOW_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


class _Fixed:
    """A part whose ``init`` returns a tree already made."""

    def __init__(self, tree):
        self.tree = tree

    def init(self, *args, **kwargs):
        return self.tree


def jax_init_params(cfg, reuse=None):
    """``PwwPipeline(cfg).init_params(0)`` as the goldens' pipeline made it,
    cast to bf16 (its ``weights_dtype``), as f32 numpy; ``reuse``: a tree
    whose "clip" and "vae" are this config's too."""
    shell = JaxPipeline.__new__(JaxPipeline)
    shell.config = cfg
    shell.clip = CLIPTextEncoder(cfg.clip)
    shell.clip2 = CLIPTextEncoder(cfg.clip2) if cfg.is_xl else None
    shell.unet = UNet2DCondition(cfg.unet)
    shell.vae = AutoencoderKL(cfg.vae)
    if reuse is not None:
        shell.clip, shell.vae = _Fixed(reuse["clip"]), _Fixed(reuse["vae"])
    params = jax.jit(lambda: shell.init_params(0)).lower().compile(LOW_OPT)()
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32)),
                        params)


def _port_config(jcfg):
    if jcfg.is_xl:
        return SDModelConfig.tiny_xl()
    return SDModelConfig.tiny(in_channels=jcfg.unet.in_channels)


@pytest.fixture(scope="module")
def golden_pipes():
    """name → the port's bf16 pipeline on the golden case's weights, one
    JAX init per config."""
    trees, pipes = {}, {}

    def tree_of(jcfg):
        key = (jcfg.is_xl, jcfg.unet.in_channels)
        if key not in trees:
            reuse = None
            if key == (False, 9):  # the 4-channel config's text tower and VAE
                reuse = tree_of(CASES["tiny_txt2img_v1"]["config"]())
            trees[key] = jax_init_params(jcfg, reuse)
        return trees[key]

    def get(name):
        if name not in pipes:
            jcfg = CASES[name]["config"]()
            pipes[name] = PwwPipeline(_port_config(jcfg), params=params_from_jax(tree_of(jcfg)),
                                      device="cpu", dtype=torch.bfloat16)
        return pipes[name]

    return get


@pytest.mark.parametrize("name", ALL_MODES)
def test_golden_latents_in_the_port(golden_pipes, name):
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    got = golden_pipes(name).generate(**CASES[name]["kwargs"]())
    assert got.shape == golden.shape
    rel = np.abs(got - golden).mean() / np.abs(golden).mean()
    assert rel < LAT_TOL, (name, rel)


@pytest.mark.parametrize("name", ALL_MODES)
def test_golden_images_in_the_port(golden_pipes, name):
    golden = np.load(os.path.join(GOLDEN, f"{name}_img.npy"))
    kwargs = CASES[name]["kwargs"]()
    kwargs.pop("return_latents")
    got = golden_pipes(name).generate(output_type="np", **kwargs)
    assert got.shape == golden.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - golden.astype(int))
    assert diff.mean() < IMG_TOL, (name, diff.mean(), diff.max())


# -- the composition proof ----------------------------------------------------------------

def _port_of(fix, in_channels=4):
    tree = jax.tree.map(np.asarray, fix["pipe"].params)
    return PwwPipeline(SDModelConfig.tiny(in_channels=in_channels),
                       params=params_from_jax(tree), device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def fix():
    f = _make_fixture(JaxSDModelConfig.tiny())
    f["port"] = _port_of(f)
    return f


@pytest.fixture(scope="module")
def fix9():
    f = _make_fixture(JaxSDModelConfig.tiny(in_channels=9))
    f["port"] = _port_of(f, 9)
    return f


def _assert_composition(pipe, kwargs, want_lat, want_img):
    """``tests/test_composition_torch.py:_assert_composition`` on the port."""
    got_lat = np.transpose(pipe.generate(return_latents=True, **kwargs), (0, 3, 1, 2))
    np.testing.assert_allclose(got_lat, want_lat, atol=2e-3, rtol=1e-3)
    got_img = pipe.generate(output_type="np", **kwargs)
    diff = np.abs(got_img[0].astype(int) - want_img.astype(int))
    assert diff.max() <= 2, f"uint8 image diff max {diff.max()}"
    assert diff.mean() < 0.05, f"uint8 image diff mean {diff.mean()}"


PROMPT = "a cat and a dog playing chess"
COMPOSITION_CASES = {  # color context, whether the run starts from init latents
    "txt2img": ({(255, 0, 0): "cat,0.8", (0, 0, 255): "dog,0.5"}, False),
    "regional seed": ({(255, 0, 0): "cat,0.8,42", (0, 0, 255): "dog,0.5"}, False),
    "img2img": ({(255, 0, 0): "cat,0.8", (0, 0, 255): "dog,0.5"}, True),
}


@pytest.mark.parametrize("case", list(COMPOSITION_CASES))
def test_full_loop_matches_reference_in_the_port(fix, case):
    """txt2img, a regional seed, and img2img from shared scaled init
    latents at strength 0.6 (the reference samples its posterior with
    unseeded global RNG, so latents are the meeting point)."""
    ctx, from_latents = COMPOSITION_CASES[case]
    cm = _color_map()
    kw = dict(prompt=PROMPT, color_map_image=cm, color_context=ctx,
              num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=11, noise_mode="torch")
    if from_latents:
        init = np.random.default_rng(3).standard_normal(
            (1, 4, SIZE // 8, SIZE // 8)).astype(np.float32)
        want = torch_reference_generate(fix, PROMPT, cm, ctx, seed=11, init_latents=init,
                                        strength=0.6)
        kw.update(strength=0.6, init_latents=np.transpose(init, (0, 2, 3, 1)))
    else:
        want = torch_reference_generate(fix, PROMPT, cm, ctx, seed=11)
    _assert_composition(fix["port"], kw, *want)


def test_full_loop_matches_reference_inpaint_in_the_port(fix9):
    """The reference's ``paint_with_words_inpaint`` on the 9-channel
    checkpoint (both sides take the posterior mean)."""
    cm = _color_map()
    ctx = {(255, 0, 0): "cat,0.8", (0, 0, 255): "dog,0.5"}
    rng = np.random.default_rng(5)
    init = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[SIZE // 4: 3 * SIZE // 4, SIZE // 3:] = 255
    want = torch_reference_generate_inpaint(fix9, PROMPT, cm, ctx, seed=11, init_image=init,
                                            mask_image=mask, strength=0.8)
    _assert_composition(
        fix9["port"],
        dict(prompt=PROMPT, color_map_image=cm, color_context=ctx, init_image=init,
             mask_image=mask.astype(np.float32) / 255.0, num_inference_steps=STEPS,
             guidance_scale=GUIDANCE, seed=11, noise_mode="torch", vae_sample_mode="mean",
             strength=0.8),
        *want)
