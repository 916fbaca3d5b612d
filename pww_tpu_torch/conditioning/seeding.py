"""Latent initialization: global seed and regional seeding.

Port of :mod:`pww_tpu.conditioning.seeding`, in both of its noise modes:
``"jax"`` (the JAX package's default) draws ``jax.random.normal(
PRNGKey(seed))`` in the JAX package's NHWC layout on the host
(:mod:`pww_tpu_torch.utils.jax_random`) and permutes it to NCHW, since an
NCHW draw gives other numbers; ``"torch"`` draws the reference's
``torch.randn`` from ``manual_seed(seed)`` on the CPU, in NCHW. Each seeded
region draws a full latent from its own seed, whose foreground (the
region's binarized mask, bilinearly resized to the latent grid) replaces
the global latent there.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..utils import jax_random
from .color_context import Region

NOISE_MODES = ("jax", "torch")


def check_noise_mode(noise_mode: str) -> None:
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"noise_mode must be 'jax' or 'torch', got {noise_mode!r}")


def normal_nchw(key, shape: Tuple[int, ...], device="cpu", dtype="float32") -> torch.Tensor:
    """``jax.random.normal(key, (b, h, w, c), dtype)``, the JAX package's
    NHWC draw, as an NCHW f32 tensor on ``device`` (``shape`` is NCHW)."""
    b, c, h, w = shape
    x = jax_random.normal(key, (b, h, w, c), dtype)
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)


def make_noise(seed: int, shape: Tuple[int, ...], noise_mode: str = "jax",
               device="cpu") -> torch.Tensor:
    """Standard-normal NCHW noise: ``"jax"``, the JAX package's
    ``jax.random.normal(PRNGKey(seed), NHWC)``; ``"torch"``, bit-identical
    to the CPU ``torch.randn(shape, generator=torch.manual_seed(seed))``."""
    check_noise_mode(noise_mode)
    if noise_mode == "jax":
        return normal_nchw(jax_random.PRNGKey(seed), shape, device)
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g).to(device)


def regional_seed_latents(
    base_latents: torch.Tensor,  # (B, C, h, w) NCHW
    regions: Sequence[Region],
    noise_mode: str = "jax",
) -> torch.Tensor:
    """Composite per-region seeded noise over the base latent."""
    seeded = [r for r in regions if r.seed is not None]
    if not seeded:
        return base_latents
    b, c, h, w = base_latents.shape
    dev = base_latents.device
    masks, lats = [], []
    for r in seeded:
        binary = torch.from_numpy((r.mask > 0).astype(np.float32)).to(dev)
        masks.append(resize_bilinear(binary[None, None], h, w,
                                     align_corners=False)[0, 0])
        lats.append(make_noise(r.seed, (b, c, h, w), noise_mode, dev))
    mask_stack = torch.stack(masks)  # (S, h, w)
    foreground = (mask_stack.sum(0) > 0)[None, None]
    summed = sum(l * m[None, None] for l, m in zip(lats, mask_stack))
    return torch.where(foreground, summed, base_latents)
