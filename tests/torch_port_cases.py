"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages run on the CPU in float32 on the same weights: a random
parameter tree with the JAX package's exact structure (``jax.eval_shape`` of
``init_params``, traced only, filled from a numpy seed) goes into the JAX
``PwwPipeline`` as is, and into the port through ``params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.clip import CLIPTextEncoder
from pww_tpu.models.unet import UNet2DCondition
from pww_tpu.models.vae import AutoencoderKL
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.weights.bridge import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for a test module, restored after it. The tiny
    shapes gain nothing from more, and in a parallel test run the spinning
    thread pools of several workers, each sized to every core, slow each
    other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_jax_params(cfg, seed: int = 0, scale: float = 0.1):
    """numpy tree shaped like ``PwwPipeline(cfg).init_params()``; norm
    scales are 1 + scale·N(0, 1), every other leaf scale·N(0, 1)."""
    shell = JaxPipeline.__new__(JaxPipeline)
    shell.config = cfg
    shell.clip = CLIPTextEncoder(cfg.clip, dtype=jnp.float32)
    shell.clip2 = CLIPTextEncoder(cfg.clip2, dtype=jnp.float32) if cfg.is_xl else None
    shell.unet = UNet2DCondition(cfg.unet, dtype=jnp.float32)
    shell.vae = AutoencoderKL(cfg.vae, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: shell.init_params(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32) * scale
        return 1.0 + x if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def pipeline_pair(jax_cfg=None, torch_cfg=None, seed: int = 0, scheduler: str = "lms"):
    """(JAX pipeline, port pipeline), f32 on the CPU, on the same weights."""
    jax_cfg = jax_cfg or JaxSDModelConfig.tiny()
    torch_cfg = torch_cfg or SDModelConfig.tiny()
    tree = random_jax_params(jax_cfg, seed)
    jp = JaxPipeline(jax_cfg, params=tree, scheduler=scheduler, compute_dtype=jnp.float32,
                     weights_dtype=jnp.float32)
    tp = PwwPipeline(torch_cfg, params=params_from_jax(tree), scheduler=scheduler,
                     device="cpu", dtype=torch.float32)
    return jp, tp


def color_map(size: int = 64) -> np.ndarray:
    """tests/golden_cases.py's map: red left half, blue top-right quarter."""
    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, : size // 2] = (255, 0, 0)
    cm[: size // 4, size // 2 :] = (0, 0, 255)
    return cm
