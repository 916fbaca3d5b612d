"""T2I-Adapter (Mou et al. 2023): hint image → one feature per UNet down block.

Port of :mod:`pww_tpu.models.t2i_adapter`, diffusers' ``T2IAdapter`` with
its ``FullAdapter``: pixel-unshuffle by the VAE's factor, a 3×3
``conv_in``, then one stage per down block of [2×2 average pool on every
stage but the first] → [1×1 ``in_conv`` where the channel count changes] →
N residual blocks (3×3 conv, ReLU, 1×1 conv, plus the input). The features
depend on the hint alone, so the pipeline computes them once per call,
outside the denoise loop, and the UNet adds them in its down blocks
(``down_intrablock_residuals``).

Parameter names are diffusers': ``adapter.conv_in``,
``adapter.body.{i}.in_conv`` and ``adapter.body.{i}.resnets.{j}.block{1,2}``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, H, W) → (B, C·f², H/f, W/f), channels ordered (c, fh, fw): the
    order the JAX package's NHWC ``pixel_unshuffle`` reproduces."""
    return F.pixel_unshuffle(x, factor)


class AdapterResnetBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.block2 = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block2(F.relu(self.block1(x)))


class AdapterBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, num_res_blocks: int, down: bool):
        super().__init__()
        self.down = down
        self.in_conv = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None
        self.resnets = nn.ModuleList(AdapterResnetBlock(c_out) for _ in range(num_res_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = F.avg_pool2d(x, 2)
        if self.in_conv is not None:
            x = self.in_conv(x)
        for block in self.resnets:
            x = block(x)
        return x


class FullAdapter(nn.Module):
    def __init__(self, channels, num_res_blocks, downscale_factor, in_channels):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels * downscale_factor ** 2, channels[0], 3, padding=1)
        self.body = nn.ModuleList(
            AdapterBlock(channels[max(i - 1, 0)], ch, num_res_blocks, down=i > 0)
            for i, ch in enumerate(channels))


class T2IAdapter(nn.Module):
    """``forward(hint)``: (B, in_channels, H, W) in [0, 1] → a tuple of
    ``len(channels)`` features, (B, channels[i], H/f/2^i, W/f/2^i), in the
    weights' dtype."""

    def __init__(self, channels: Tuple[int, ...] = (320, 640, 1280, 1280),
                 num_res_blocks: int = 2, downscale_factor: int = 8, in_channels: int = 3):
        super().__init__()
        if in_channels not in (1, 3):
            raise ValueError(f"in_channels must be 1 or 3, got {in_channels}")
        self.in_channels = in_channels
        self.downscale_factor = downscale_factor
        self.adapter = FullAdapter(tuple(channels), num_res_blocks, downscale_factor,
                                   in_channels)

    def forward(self, hint: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dtype = self.adapter.conv_in.weight.dtype
        x = self.adapter.conv_in(pixel_unshuffle(hint.to(dtype), self.downscale_factor))
        feats = []
        for stage in self.adapter.body:
            x = stage(x)
            feats.append(x)
        return tuple(feats)
