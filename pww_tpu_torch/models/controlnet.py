"""ControlNet sharing the UNet's paint-with-words attention.

Port of :mod:`pww_tpu.models.controlnet`: a copy of the UNet's encoder
(``conv_in``, the down blocks, the mid block) whose input is the latents
plus an embedding of the hint image, and one zero-initialised 1×1 conv per
UNet skip and on the mid block's output. Its blocks are the port's own
(:class:`~pww_tpu_torch.models.unet.DownBlock`,
:class:`~pww_tpu_torch.models.unet.UNetMidBlock2DCrossAttn`), so its
attention goes through the same dispatch as the UNet's and reaches K1-K3 at
the same sites and thresholds, on the same :class:`PwwState`. An SDXL
(``text_time``) net has the UNet's ``add_embedding`` too: the pooled text
and the Fourier features of the micro-conditioning ``time_ids``, through a
``TimestepEmbedding``, join the timestep embedding
(``pww_tpu/models/controlnet.py:95-109``).

Parameter names are diffusers' ``ControlNetModel``'s:
``controlnet_cond_embedding.{conv_in,blocks.{i},conv_out}``,
``controlnet_down_blocks.{i}``, ``controlnet_mid_block``, and the UNet's
names for the rest. The conditioning embedding's ``conv_out`` is diffusers'
3×3 conv; the JAX package's is 1×1 (ROADMAP C.8), and its weights come
across as the centre tap of a 3×3 kernel, which computes the same
function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import UNetConfig
from ..types import PwwState
from .unet import (DownBlock, TimestepEmbedding, UNetMidBlock2DCrossAttn, skip_channels,
                   text_time_embedding, timestep_embedding)

# The zero-initialised convs: a ControlNet built with none of its own
# weights is a no-op until they are trained (or loaded)
ZERO_CONV_PREFIXES = ("controlnet_down_blocks.", "controlnet_mid_block.",
                      "controlnet_cond_embedding.conv_out.")


class ControlNetConditioningEmbedding(nn.Module):
    """(B, 3, H, W) hint in [0, 1] → (B, C, H/8, W/8): convs of 16, 32, 96
    and 256 channels, three of them stride 2, SiLU after each."""

    def __init__(self, out_channels: int, in_channels: int = 3,
                 channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            self.blocks.append(nn.Conv2d(c_in, c_in, 3, padding=1))
            self.blocks.append(nn.Conv2d(c_in, c_out, 3, padding=1, stride=2))
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, hint: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(hint))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNetModel(nn.Module):
    """Returns (down-block residuals, one per UNet skip; mid-block residual),
    each multiplied by the conditioning scale in the compute dtype."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        n = len(chs)
        temb_dim = chs[0] * cfg.time_embed_mult
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(chs[0])
        self.down_blocks = nn.ModuleList(
            DownBlock(chs[max(i - 1, 0)], chs[i], temb_dim, cfg,
                      cfg.down_block_has_attn[i], i == n - 1, cfg.depth_for(i))
            for i in range(n)
        )
        self.mid_block = UNetMidBlock2DCrossAttn(chs[-1], temb_dim, cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_channels(cfg))
        self.controlnet_mid_block = nn.Conv2d(chs[-1], chs[-1], 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, hint: torch.Tensor,
                pww: Optional[PwwState] = None, conditioning_scale: float = 1.0,
                added_cond: Optional[dict] = None):
        """``sample`` (B, C, h, w) latents, ``hint`` (B, 3, 8h, 8w) in [0, 1];
        ``added_cond`` = {"text_embeds", "time_ids"} for a ``text_time`` net
        (required there, ignored elsewhere, as in the JAX ControlNet)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dtype))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("text_time ControlNet requires added_cond (SDXL)")
            temb = temb + text_time_embedding(self.add_embedding, added_cond,
                                              cfg.addition_time_embed_dim, dtype)
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype)) + self.controlnet_cond_embedding(hint.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x = blk(x, temb, ctx, pww, skips)
        x = self.mid_block(x, temb, ctx, pww)
        # the scale, an f32 in the reference's pipeline, rounded to the
        # compute dtype before the product (pww_tpu/models/controlnet.py:179-183)
        scale = float(torch.tensor(conditioning_scale, dtype=torch.float32, device="cpu").to(dtype))
        down = tuple(conv(s) * scale for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(x) * scale
