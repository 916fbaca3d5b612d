"""SD-1.x UNet2DCondition with first-class paint-with-words bias threading.

Port of :mod:`pww_tpu.models.unet` for SD-1.x, as a torch ``nn.Module``
with diffusers' ``UNet2DConditionModel`` parameter names, NCHW inside the
conv stacks. GroupNorm and LayerNorm compute in f32 and cast to the
compute dtype; GroupNorm epsilon is 1e-5 in the ResNets and 1e-6 in
Transformer2D; GEGLU uses the exact f32 GELU.

Attention dispatch (``pww_tpu/models/unet.py:177-211``), per site:
  * self-attention with L >= ``flash_min_seq`` → K3 flash kernel;
  * cross-attention with a PwW bias, Lq >= ``fused_cross_min_seq`` and a
    structured weight function → K1 reduce, then K2 fused cross-attention;
  * everything else → dense :func:`pww_attention`.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import UNetConfig
from ..ops.attention import merge_heads, pww_attention, split_heads
from ..ops.cross_attention_kernel import fused_pww_cross_attention, fused_pww_reduce
from ..ops.flash_attention import flash_self_attention
from ..ops.group_norm import group_norm_f32
from ..ops.layer_norm import layer_norm_f32
from ..ops.weight_functions import CustomWeightFunction
from ..types import PwwState


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, SD convention (flip_sin_to_cos=True, shift=0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c_in, eps=1e-5)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = nn.GroupNorm(groups, c_out, eps=1e-5)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(group_norm_f32(self.norm1, x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(group_norm_f32(self.norm2, h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 GEGLU, net.1 dropout (no params), net.2 out
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class Attention(nn.Module):
    """q from hidden states; k, v from a context sequence (or the states)."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, cfg: UNetConfig):
        super().__init__()
        self.heads = heads
        self.cfg = cfg
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                pww: Optional[PwwState] = None) -> torch.Tensor:
        cfg = self.cfg
        is_self = context is None
        ctx = x if is_self else context
        q, k, v = (split_heads(t, self.heads)
                   for t in (self.to_q(x), self.to_k(ctx), self.to_v(ctx)))
        lq = q.shape[2]
        bias_w = weight_fn = sigma = None
        if pww is not None and not is_self:
            bias_w = pww.bias_for(lq)
            weight_fn, sigma = pww.weight_fn, pww.sigma
        if is_self and cfg.flash_attention and lq >= cfg.flash_min_seq:
            out = flash_self_attention(q, k, v)
        elif (bias_w is not None and cfg.fused_cross_attention
              and lq >= cfg.fused_cross_min_seq
              and not isinstance(weight_fn, CustomWeightFunction)):
            coef = weight_fn.sigma_coef(sigma) * fused_pww_reduce(q, k, weight_fn)
            out = fused_pww_cross_attention(q, k, v, bias_w, coef)
        else:
            out = pww_attention(q, k, v, bias_w=bias_w, weight_fn=weight_fn,
                                sigma=sigma)
        return self.to_out[0](merge_heads(out))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, cfg: UNetConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads, cfg)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, ctx_dim, heads, cfg)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, pww):
        x = x + self.attn1(layer_norm_f32(self.norm1, x))
        x = x + self.attn2(layer_norm_f32(self.norm2, x), context, pww)
        return x + self.ff(layer_norm_f32(self.norm3, x))


class Transformer2DModel(nn.Module):
    """GroupNorm → 1x1 proj → transformer block over flattened space → 1x1 proj."""

    def __init__(self, channels: int, ctx_dim: int, heads: int, cfg: UNetConfig):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, ctx_dim, heads, cfg)]
        )
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, pww):
        b, c, h, w = x.shape
        z = self.proj_in(group_norm_f32(self.norm, x))
        z = z.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            z = blk(z, context, pww)
        z = z.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(z) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (with attentions) or DownBlock2D."""

    def __init__(self, c_in, c_out, temb_dim, cfg: UNetConfig, has_attn, last):
        super().__init__()
        nh = cfg.heads_for(c_out)[0]
        self.resnets = nn.ModuleList(
            ResnetBlock2D(c_in if i == 0 else c_out, c_out, temb_dim,
                          cfg.norm_num_groups)
            for i in range(cfg.layers_per_block)
        )
        self.attentions = nn.ModuleList(
            Transformer2DModel(c_out, cfg.cross_attention_dim, nh, cfg)
            for _ in range(cfg.layers_per_block)
        ) if has_attn else None
        self.downsamplers = None if last else nn.ModuleList([Downsample2D(c_out)])

    def forward(self, x, temb, ctx, pww, skips: List[torch.Tensor]):
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx, pww)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (with attentions) or UpBlock2D."""

    def __init__(self, c_prev, c_out, skip_chs, temb_dim, cfg: UNetConfig,
                 has_attn, last):
        super().__init__()
        nh = cfg.heads_for(c_out)[0]
        self.resnets = nn.ModuleList(
            ResnetBlock2D((c_prev if i == 0 else c_out) + skip_chs[i], c_out,
                          temb_dim, cfg.norm_num_groups)
            for i in range(cfg.layers_per_block + 1)
        )
        self.attentions = nn.ModuleList(
            Transformer2DModel(c_out, cfg.cross_attention_dim, nh, cfg)
            for _ in range(cfg.layers_per_block + 1)
        ) if has_attn else None
        self.upsamplers = None if last else nn.ModuleList([Upsample2D(c_out)])

    def forward(self, x, temb, ctx, pww, skips: List[torch.Tensor]):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx, pww)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, ch, temb_dim, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim, cfg.norm_num_groups) for _ in range(2)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(ch, cfg.cross_attention_dim, cfg.heads_for(ch)[0], cfg)]
        )

    def forward(self, x, temb, ctx, pww):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx, pww)
        return self.resnets[1](x, temb)


class UNet2DConditionModel(nn.Module):
    """SD-1.x UNet; ``pww`` carries the paint-with-words bias pyramid."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        n = len(chs)
        temb_dim = chs[0] * cfg.time_embed_mult
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        self.down_blocks = nn.ModuleList(
            DownBlock(chs[max(i - 1, 0)], chs[i], temb_dim, cfg,
                      cfg.down_block_has_attn[i], i == n - 1)
            for i in range(n)
        )
        self.mid_block = UNetMidBlock2DCrossAttn(chs[-1], temb_dim, cfg)
        # skip channels, in the order the up path pops them
        skip_chs = [chs[0]]
        for i, ch in enumerate(chs):
            skip_chs += [ch] * cfg.layers_per_block + ([ch] if i < n - 1 else [])
        rev = list(reversed(chs))
        ups = []
        for i, ch in enumerate(rev):
            pops = [skip_chs.pop() for _ in range(cfg.layers_per_block + 1)]
            ups.append(UpBlock(rev[max(i - 1, 0)], ch, pops, temb_dim, cfg,
                               cfg.up_block_has_attn[i], i == n - 1))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chs[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pww: Optional[PwwState] = None) -> torch.Tensor:
        """(B, C_in, h, w) latents → (B, C_out, h, w) in the compute dtype."""
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, self.config.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dtype))
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x = blk(x, temb, ctx, pww, skips)
        x = self.mid_block(x, temb, ctx, pww)
        for blk in self.up_blocks:
            x = blk(x, temb, ctx, pww, skips)
        return self.conv_out(group_norm_f32(self.conv_norm_out, x, silu=True))
