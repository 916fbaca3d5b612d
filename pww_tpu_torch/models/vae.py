"""AutoencoderKL (SD 1.x VAE) as a torch ``nn.Module``: encoder, decoder,
diagonal Gaussian posterior.

Port of :mod:`pww_tpu.models.vae`, NCHW, with diffusers' ``AutoencoderKL``
parameter names (``encoder.*``, ``quant_conv.*``, ``post_quant_conv.*``,
``decoder.*``; the mid attention uses the current ``to_q``/``to_k``/
``to_v``/``to_out.0``/``group_norm`` naming). GroupNorms (eps 1e-6) run
kernel K4 (SiLU fused) where their input is bf16 on the card and autograd
records no gradient through it (``ops/cuda_build.py:
norm_site_takes_kernel``), and compute in f32 elsewhere: the CPU, f32
pipelines, training. ``VAEConfig.fused_group_norm`` sends every site to K4
on every device (the plain K4 on the CPU).

The decoder runs spatially sharded inside a ``generate(sharding="spatial")``
call (:mod:`pww_tpu_torch.parallel.spatial`): each rank decodes its rows of
the latents, its 3×3 convolutions exchanging a row with each neighbour,
its GroupNorms combining their moments over dp, and its mid-block
attention's queries attending the keys and values gathered over dp. The
encoder runs whole on every rank (the JAX package encodes the init image
before it places the init latents).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..conditioning.seeding import normal_nchw
from ..config import VAEConfig
from ..ops.group_norm import group_norm_site
from ..parallel import spatial


class VAEResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int, fused_norm: bool):
        super().__init__()
        self.fused_norm = fused_norm
        self.norm1 = nn.GroupNorm(groups, c_in, eps=1e-6)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, c_out, eps=1e-6)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = spatial.conv(self.conv1, group_norm_site(self.norm1, x, fused=self.fused_norm,
                                                     silu=True))
        h = spatial.conv(self.conv2, group_norm_site(self.norm2, h, fused=self.fused_norm,
                                                     silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (diffusers AttentionBlock)."""

    def __init__(self, c: int, groups: int, fused_norm: bool):
        super().__init__()
        self.fused_norm = fused_norm
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        sp = spatial.site(x)
        z = group_norm_site(self.group_norm, x, fused=self.fused_norm)
        z = z.reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(z), self.to_k(z), self.to_v(z)
        if sp is not None:  # this rank's rows' queries, every row's keys
            k, v = sp.gather_tokens(k, v, dim=1)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(scores * c ** -0.5, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class VAEUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        x = spatial.settle(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return spatial.conv(self.conv, x)


class VAEUpBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: VAEConfig, last: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(c_in if i == 0 else c_out, c_out, cfg.norm_num_groups,
                           cfg.fused_group_norm)
            for i in range(cfg.layers_per_block + 1)
        )
        self.upsamplers = None if last else nn.ModuleList([VAEUpsample(c_out)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class VAEDownsample(nn.Module):
    """diffusers' VAE downsample: asymmetric (0, 1) pad, stride-2 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEDownBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: VAEConfig, last: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(c_in if i == 0 else c_out, c_out, cfg.norm_num_groups,
                           cfg.fused_group_norm)
            for i in range(cfg.layers_per_block)
        )
        self.downsamplers = None if last else nn.ModuleList([VAEDownsample(c_out)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class VAEMidBlock(nn.Module):
    def __init__(self, c: int, groups: int, fused_norm: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(c, c, groups, fused_norm) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, groups, fused_norm)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.fused_norm = cfg.fused_group_norm
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            VAEDownBlock(chs[max(i - 1, 0)], ch, cfg, i == len(chs) - 1)
            for i, ch in enumerate(chs)
        )
        self.mid_block = VAEMidBlock(chs[-1], cfg.norm_num_groups, cfg.fused_group_norm)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(group_norm_site(self.conv_norm_out, h, fused=self.fused_norm,
                                             silu=True))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.fused_norm = cfg.fused_group_norm
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], cfg.norm_num_groups, cfg.fused_group_norm)
        self.up_blocks = nn.ModuleList(
            VAEUpBlock(rev[max(i - 1, 0)], ch, cfg, i == len(rev) - 1)
            for i, ch in enumerate(rev)
        )
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(spatial.conv(self.conv_in, z))
        for blk in self.up_blocks:
            h = blk(h)
        return spatial.conv(self.conv_out, group_norm_site(
            self.conv_norm_out, h, fused=self.fused_norm, silu=True))


class AutoencoderKL(nn.Module):
    """The SD VAE. ``encode_moments`` maps a (B, 3, H, W) image in [-1, 1]
    to (B, 2·latent, h, w) posterior mean and log-variance; ``decode`` maps
    (B, 4, h, w) *unscaled* latents to a (B, 3, H, W) image in [-1, 1]
    (compute dtype)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = VAEEncoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = VAEDecoder(cfg)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))


def sample_from_moments(moments: torch.Tensor, key, dtype="float32") -> torch.Tensor:
    """Sample the diagonal Gaussian posterior (log-variance clamped to
    [-30, 20], as diffusers), f32, with the JAX package's standard normals:
    ``jax.random.normal(key, NHWC, dtype)`` drawn on the host
    (``pww_tpu/models/vae.py:176-181``; ``dtype`` is the dtype of the JAX
    pipeline's moments, its compute dtype)."""
    mean, logvar = moments.float().chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mean + std * normal_nchw(key, tuple(mean.shape), mean.device, dtype)
