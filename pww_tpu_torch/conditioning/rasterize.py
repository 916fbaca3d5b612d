"""Bias-pyramid rasterization on the device.

Port of :mod:`pww_tpu.conditioning.rasterize`: all region masks are stacked
into one (R, H, W) tensor, resized with ``F.interpolate(bilinear,
align_corners=True)`` numerics at every UNet attention resolution, and
contracted against the (R, n_tokens) token-match matrix per level.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.blur import gaussian_blur
from ..ops.resize import resize_bilinear
from .color_context import always_round

PYRAMID_RATIOS = (8, 16, 32, 64)


def pyramid_level_shape(h: int, w: int, ratio: int) -> Tuple[int, int]:
    """Reference's rounding quirk: sizes via :func:`always_round`."""
    return always_round(h / ratio), always_round(w / ratio)


def rasterize_pyramid(
    masks: torch.Tensor,  # (R, H, W) strength-scaled region masks
    token_match: torch.Tensor,  # (R, T) occurrence counts
    blur_sigmas: Optional[Sequence[float]] = None,  # (R,) host; 0 = no blur
    *,
    height: int,
    width: int,
    ratios: Tuple[int, ...] = PYRAMID_RATIOS,
) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
    """Returns ({h_r*w_r: (h_r*w_r, T)}, full-res (H, W, T) ``ORIG`` map).

    Keys collide across ratios like the reference's size-keyed dict: later
    (coarser) levels win.
    """
    masks = masks.float()
    token_match = token_match.float()
    if blur_sigmas is not None:
        masks = torch.stack([
            gaussian_blur(m, 39, float(s)) if s > 0 else m
            for m, s in zip(masks, blur_sigmas)
        ])
    pyramid: Dict[int, torch.Tensor] = {}
    for ratio in ratios:
        h_r, w_r = pyramid_level_shape(height, width, ratio)
        down = resize_bilinear(masks, h_r, w_r, align_corners=True)
        flat = down.reshape(masks.shape[0], h_r * w_r)
        pyramid[h_r * w_r] = torch.einsum("rq,rt->qt", flat, token_match)
    orig = torch.einsum("rhw,rt->hwt", masks, token_match)
    return pyramid, orig
