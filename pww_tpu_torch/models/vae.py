"""AutoencoderKL decoder (SD 1.x VAE) as a torch ``nn.Module``.

Port of the decoder half of :mod:`pww_tpu.models.vae`, with diffusers'
``AutoencoderKL`` parameter names (``post_quant_conv.*``, ``decoder.*``;
the mid attention uses the current ``to_q``/``to_k``/``to_v``/``to_out.0``
/``group_norm`` naming). GroupNorms (eps 1e-6) compute in f32. The encoder
comes with img2img.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig
from ..ops.group_norm import group_norm_f32


class VAEResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c_in, eps=1e-6)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, c_out, eps=1e-6)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(group_norm_f32(self.norm1, x, silu=True))
        h = self.conv2(group_norm_f32(self.norm2, h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (diffusers AttentionBlock)."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        z = group_norm_f32(self.group_norm, x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(z), self.to_k(z), self.to_v(z)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(scores * c ** -0.5, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class VAEUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEUpBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: VAEConfig, last: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(c_in if i == 0 else c_out, c_out, cfg.norm_num_groups)
            for i in range(cfg.layers_per_block + 1)
        )
        self.upsamplers = None if last else nn.ModuleList([VAEUpsample(c_out)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class VAEMidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(c, c, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], cfg.norm_num_groups)
        self.up_blocks = nn.ModuleList(
            VAEUpBlock(rev[max(i - 1, 0)], ch, cfg, i == len(rev) - 1)
            for i, ch in enumerate(rev)
        )
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(group_norm_f32(self.conv_norm_out, h, silu=True))


class AutoencoderKL(nn.Module):
    """Decoder side of the SD VAE: ``decode`` maps (B, 4, h, w) *unscaled*
    latents to a (B, 3, H, W) image in [-1, 1] (compute dtype)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = VAEDecoder(cfg)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))
