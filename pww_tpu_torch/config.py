"""Frozen configuration dataclasses for the PyTorch port.

Mirrors :mod:`pww_tpu.config` for SD-1.x (txt2img, img2img, inpaint) and
SD-2.x (head dim 64, OpenCLIP-H text tower, v-prediction). The knobs that only shaped TPU code (conv lowering, head-dim lane
padding, cross-attention grid-order variants, Mosaic block sizes) are not
carried over; the kernel dispatch thresholds and the norm-kernel switches
are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text-encoder hyperparameters (SD 1.x: openai/clip-vit-large-patch14)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # SD 1.x; "gelu" for OpenCLIP towers

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        """SD-2.x: the OpenCLIP-H text tower as diffusers stores it (23 layers)."""
        return CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_layers=23,
                              num_heads=16, hidden_act="gelu")

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_position_embeddings=77,
        )


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD UNet2DConditionModel hyperparameters (SD-1.5 defaults)."""

    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # SD-1.x: 8 heads everywhere; a set attention_head_dim fixes dh instead.
    num_attention_heads: int = 8
    attention_head_dim: Optional[int] = None
    cross_attention_dim: int = 768
    # "epsilon" (SD-1.x) or "v_prediction" (SD-2.x 768-v)
    prediction_type: str = "epsilon"
    norm_num_groups: int = 32
    time_embed_mult: int = 4
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    # Kernel dispatch (pww_tpu/models/unet.py:177-211): self-attention with
    # L >= flash_min_seq runs the flash kernel; PwW cross-attention with
    # Lq >= fused_cross_min_seq runs the reduce + fused cross-attention pair.
    flash_attention: bool = True
    fused_cross_attention: bool = True
    flash_min_seq: int = 1024
    fused_cross_min_seq: int = 256
    # The GroupNorm (K4) and LayerNorm (K5) kernels at every UNet norm site;
    # off by default, as in pww_tpu/config.py:201-202.
    fused_group_norm: bool = False
    fused_layer_norm: bool = False

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))

    def heads_for(self, channels: int) -> Tuple[int, int]:
        """(num_heads, head_dim) at a resolution."""
        if self.attention_head_dim is not None:
            return channels // self.attention_head_dim, self.attention_head_dim
        return self.num_attention_heads, channels // self.num_attention_heads

    @staticmethod
    def sd15(in_channels: int = 4) -> "UNetConfig":
        return UNetConfig(in_channels=in_channels)

    @staticmethod
    def sd21(v_prediction: bool = True) -> "UNetConfig":
        """SD-2.1 (768-v by default): head dim 64, 1024-dim OpenCLIP context."""
        return UNetConfig(
            attention_head_dim=64,
            cross_attention_dim=1024,
            sample_size=96 if v_prediction else 64,
            prediction_type="v_prediction" if v_prediction else "epsilon",
        )

    @staticmethod
    def sd15_inpaint() -> "UNetConfig":
        """9-channel inpainting UNet (runwayml/stable-diffusion-inpainting)."""
        return UNetConfig(in_channels=9)

    @staticmethod
    def tiny(in_channels: int = 4, cross_attention_dim: int = 32) -> "UNetConfig":
        return UNetConfig(
            in_channels=in_channels,
            block_out_channels=(32, 64),
            layers_per_block=1,
            num_attention_heads=4,
            cross_attention_dim=cross_attention_dim,
            norm_num_groups=8,
            down_block_has_attn=(True, False),
            sample_size=16,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL hyperparameters (SD 1.x)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # The GroupNorm kernel (K4) at every encoder and decoder norm site; off
    # by default, as in pww_tpu/config.py:305.
    fused_group_norm: bool = False

    @property
    def scale_factor(self) -> int:
        """Spatial downsampling factor (8 for SD: 3 stride-2 stages)."""
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(8, 16, 16, 32), layers_per_block=1,
            norm_num_groups=4,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Noise schedule shared by every scheduler (the reference's hardcoded
    LMS construction)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 0
    # DDIM's final-step ᾱ_prev: True → 1.0 (diffusers' bare-constructor
    # default), False → ᾱ[0] (what SD checkpoints ship); PNDM always uses ᾱ[0].
    set_alpha_to_one: bool = True
    # Karras et al. (2022) ρ=7 sigma spacing (lms/euler/euler_ancestral/heun,
    # and the trajectories of dpmpp_2m, dpmpp_2m_sde and unipc).
    use_karras_sigmas: bool = False


@dataclasses.dataclass(frozen=True)
class SDModelConfig:
    """A model family bundle: SD-1.x, SD-1.x inpainting, SD-2.x."""

    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig.sd15)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig.sd15)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig.sd15)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)

    @staticmethod
    def sd15() -> "SDModelConfig":
        return SDModelConfig()

    @staticmethod
    def sd15_inpaint() -> "SDModelConfig":
        return SDModelConfig(unet=UNetConfig.sd15_inpaint())

    @staticmethod
    def sd21(v_prediction: bool = True) -> "SDModelConfig":
        return SDModelConfig(clip=CLIPTextConfig.sd21(), unet=UNetConfig.sd21(v_prediction))

    @staticmethod
    def tiny(in_channels: int = 4) -> "SDModelConfig":
        clip = CLIPTextConfig.tiny()
        return SDModelConfig(
            clip=clip,
            unet=UNetConfig.tiny(in_channels, cross_attention_dim=clip.hidden_size),
            vae=VAEConfig.tiny(),
        )
