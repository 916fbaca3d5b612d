"""Latent initialization: global seed and regional seeding.

Port of :mod:`pww_tpu.conditioning.seeding` for ``noise_mode="torch"``: the
reference draws ``torch.randn`` from ``manual_seed(seed)`` on the CPU, in
NCHW, and each seeded region draws a full latent from its own seed, whose
foreground (the region's binarized mask, bilinearly resized to the latent
grid) replaces the global latent there.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from .color_context import Region


def make_noise(seed: int, shape: Tuple[int, ...], noise_mode: str = "torch",
               device="cpu") -> torch.Tensor:
    """Standard-normal NCHW noise, bit-identical to the CPU
    ``torch.randn(shape, generator=torch.manual_seed(seed))`` draw."""
    if noise_mode != "torch":
        raise NotImplementedError(
            f"noise_mode={noise_mode!r}: the port draws the reference's "
            "torch noise only (noise_mode='torch')"
        )
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g).to(device)


def regional_seed_latents(
    base_latents: torch.Tensor,  # (B, C, h, w) NCHW
    regions: Sequence[Region],
    noise_mode: str = "torch",
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
