"""Frozen configuration dataclasses for the PyTorch port.

Mirrors :mod:`pww_tpu.config` for SD-1.x (txt2img, img2img, inpaint),
SD-2.x (head dim 64, OpenCLIP-H text tower, v-prediction) and SDXL base and
refiner (dual or single projected text tower, transformer depth per stage,
``text_time`` micro-conditioning) and LCM-distilled UNets
(``time_cond_proj_dim``), and the IP-Adapter's image tower
(:class:`CLIPVisionConfig`) and image-prompt tokens
(``UNetConfig.ip_adapter_tokens``). ToMe, FreeU and SAG are per-call
options of the UNet's forward here, not config fields as in the JAX
package. The knobs that only shaped TPU code (conv lowering, head-dim lane
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
    # width of the bias-free text_projection head (SDXL's pooled
    # conditioning); None = no head
    projection_dim: Optional[int] = None
    # the pooled vector's position is the first eos_token_id; None (or the
    # legacy 2 of SD config files) takes the largest id instead
    eos_token_id: Optional[int] = None

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sdxl_l() -> "CLIPTextConfig":
        """SDXL's text_encoder: CLIP ViT-L/14 (penultimate hidden state, no
        projection head)."""
        return CLIPTextConfig()

    @staticmethod
    def sdxl_bigg() -> "CLIPTextConfig":
        """SDXL's text_encoder_2: the OpenCLIP ViT-bigG/14 text tower."""
        return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                              num_heads=20, hidden_act="gelu", projection_dim=1280,
                              eos_token_id=49407)

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
class CLIPVisionConfig:
    """CLIP vision tower (IP-Adapter image conditioning); the defaults are
    OpenCLIP ViT-H/14, the encoder the published SD-1.5 and SDXL
    ``vit-h`` IP-Adapters pair with (``pww_tpu/config.py:95-122``)."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 1024

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            image_size=32, patch_size=8, projection_dim=24,
        )


@dataclasses.dataclass(frozen=True)
class LDMBertConfig:
    """LDM-BERT, the original latent-diffusion text tower
    (``pww_tpu/config.py:62-92``): the reference converter's
    ``create_ldm_bert_config`` with diffusers' defaults, 8 heads of 64 (an
    attention width of 512, not ``d_model``), the BERT vocabulary, 77
    positions; txt2img-1p4B has ``d_model`` 1280 and 32 layers."""

    vocab_size: int = 30522
    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 5120
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def tiny() -> "LDMBertConfig":
        return LDMBertConfig(vocab_size=100, d_model=32, num_layers=2, num_heads=2,
                             head_dim=8, ffn_dim=64, max_position_embeddings=16)


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
    # transformer blocks per attention site, per down block (SDXL: (0, 2,
    # 10)); None = 1 everywhere
    transformer_depth: Optional[Tuple[int, ...]] = None
    # SDXL micro-conditioning: "text_time" adds an MLP of [pooled text ‖
    # sinusoidal(time_ids)] to the timestep embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    # LCM-distilled UNets: width of the Fourier guidance-scale embedding that
    # ``time_embedding.cond_proj`` adds to the timestep embedding (diffusers'
    # ``time_cond_proj_dim``; 256 for LCM-Dreamshaper-v7); None = none
    time_cond_proj_dim: Optional[int] = None
    # IP-Adapter: the number of image-prompt tokens; set, every attn2 gains
    # the decoupled ``to_k_ip``/``to_v_ip`` projections (set by
    # ``PwwPipeline.load_ip_adapter``); None = no image branch
    ip_adapter_tokens: Optional[int] = None
    # ToMe (a per-call ``tome_ratio``) merges only at the self-attention
    # sites of at least this many tokens (tomesd's max_downsample=1 at 512²)
    tome_min_tokens: int = 4096
    # Kernel dispatch (pww_tpu/models/unet.py:177-211): self-attention with
    # L >= flash_min_seq runs the flash kernel; PwW cross-attention with
    # Lq >= fused_cross_min_seq runs the reduce + fused cross-attention pair.
    flash_attention: bool = True
    fused_cross_attention: bool = True
    flash_min_seq: int = 1024
    fused_cross_min_seq: int = 256
    # The GroupNorm (K4) and LayerNorm (K5) kernels at every UNet norm site
    # on every device (the plain versions on the CPU); off by default, as in
    # pww_tpu/config.py:201-202. Off, a site still runs its kernel where its
    # input is bf16 on the card and autograd records no gradient through it
    # (and, for K5, the width is a multiple of 8 of at most 2048); the CPU,
    # f32 pipelines and training run the f32 composition
    # (ops/group_norm.py:group_norm_site, ops/layer_norm.py:layer_norm_site).
    fused_group_norm: bool = False
    fused_layer_norm: bool = False

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))

    def depth_for(self, block_index: int) -> int:
        """Transformer depth of down block ``block_index`` (the mid block
        takes the last block's, up block ``i`` the mirrored index's)."""
        if self.transformer_depth is None:
            return 1
        return self.transformer_depth[block_index]

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
    def sdxl() -> "UNetConfig":
        """SDXL-base: 3 stages, transformer depth (0, 2, 10) with no
        attention in stage 0, 2048-dim dual-CLIP context, text_time
        micro-conditioning (1280 + 6·256 = 2816)."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            attention_head_dim=64,
            cross_attention_dim=2048,
            sample_size=128,
            down_block_has_attn=(False, True, True),
            transformer_depth=(0, 2, 10),
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2816,
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
    # The GroupNorm kernel (K4) at every encoder and decoder norm site on
    # every device (the plain K4 on the CPU); off by default, as in
    # pww_tpu/config.py:305. Off, a site still runs K4 where its input is
    # bf16 on the card and autograd records no gradient through it; the CPU,
    # f32 pipelines and training run the f32 composition
    # (ops/group_norm.py:group_norm_site).
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
    # LCM: timesteps come from the teacher's original_inference_steps-point
    # DDIM grid; the boundary scalings c_skip and c_out are taken at
    # timestep_scaling·t with the constant sigma_data
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for data/tensor parallel execution."""

    data_axis: str = "dp"
    model_axis: str = "tp"
    data_parallel: int = 1
    tensor_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class SDModelConfig:
    """A model family bundle: SD-1.x, SD-1.x inpainting, SD-2.x, SDXL base
    and refiner."""

    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig.sd15)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig.sd15)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig.sd15)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    # SDXL-base's second text tower; None for SD-1.x/2.x and the refiner
    clip2: Optional[CLIPTextConfig] = None
    # SDXL: an empty negative prompt gives all-zero uncond text states and
    # pooled vector instead of encoding "" (diffusers'
    # force_zeros_for_empty_prompt, the JAX package's default for every
    # text_time model)
    force_zeros_for_empty_prompt: bool = True
    # SDXL-refiner: one projected tower (the bigG, in the ``clip`` slot) and
    # 5 time_ids ending in the aesthetic score
    xl_refiner: bool = False

    @property
    def is_xl(self) -> bool:
        return self.clip2 is not None

    @property
    def needs_pooled(self) -> bool:
        """A pooled text vector and time_ids are UNet inputs."""
        return self.unet.addition_embed_type == "text_time"

    @property
    def pooled_dim(self) -> int:
        src = self.clip2 if self.clip2 is not None else self.clip
        if src.projection_dim is None:
            raise ValueError("text_time conditioning needs projection_dim")
        return src.projection_dim

    @property
    def num_time_ids(self) -> int:
        """6 for the base (size, crop, target size), 5 for the refiner
        (size, crop, aesthetic score)."""
        return ((self.unet.projection_class_embeddings_input_dim - self.pooled_dim)
                // self.unet.addition_time_embed_dim)

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
    def sdxl() -> "SDModelConfig":
        """SDXL-base-1.0: ViT-L and bigG penultimate states concatenated to
        a 2048-dim context, the bigG's pooled vector, VAE scaling 0.13025."""
        return SDModelConfig(clip=CLIPTextConfig.sdxl_l(), clip2=CLIPTextConfig.sdxl_bigg(),
                             unet=UNetConfig.sdxl(), vae=VAEConfig(scaling_factor=0.13025))

    @staticmethod
    def sdxl_refiner() -> "SDModelConfig":
        """SDXL-refiner-1.0: the bigG tower alone (1280-dim context), 4
        stages (384, 768, 1536, 1536) with depth-4 attention in the middle
        two and the mid block, aesthetic-score micro-conditioning (1280 +
        5·256 = 2560)."""
        return SDModelConfig(
            clip=CLIPTextConfig.sdxl_bigg(),
            unet=UNetConfig(
                block_out_channels=(384, 768, 1536, 1536),
                attention_head_dim=64,
                cross_attention_dim=1280,
                sample_size=128,
                down_block_has_attn=(False, True, True, False),
                transformer_depth=(4, 4, 4, 4),
                addition_embed_type="text_time",
                projection_class_embeddings_input_dim=2560,
            ),
            vae=VAEConfig(scaling_factor=0.13025),
            xl_refiner=True,
        )

    @staticmethod
    def tiny_xl() -> "SDModelConfig":
        """Tiny SDXL-shaped config: two towers, concatenated context,
        text_time micro-conditioning, depth-2 transformers, no attention in
        block 0."""
        clip = CLIPTextConfig.tiny()
        clip2 = CLIPTextConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                               num_layers=2, num_heads=4, hidden_act="gelu",
                               projection_dim=64, eos_token_id=1)  # the toy tokenizer's eos
        return SDModelConfig(
            clip=clip,
            clip2=clip2,
            unet=UNetConfig(
                block_out_channels=(32, 64),
                layers_per_block=1,
                num_attention_heads=4,
                cross_attention_dim=clip.hidden_size + clip2.hidden_size,
                norm_num_groups=8,
                down_block_has_attn=(False, True),
                transformer_depth=(0, 2),
                addition_embed_type="text_time",
                addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=64 + 6 * 8,
                sample_size=16,
            ),
            vae=VAEConfig.tiny(),
        )

    @staticmethod
    def tiny_xl_refiner() -> "SDModelConfig":
        """Tiny refiner-shaped config: one projected tower, 5 time_ids,
        attention only in the inner block."""
        clip = CLIPTextConfig(vocab_size=1000, hidden_size=48, intermediate_size=96,
                              num_layers=2, num_heads=4, hidden_act="gelu",
                              projection_dim=48, eos_token_id=1)
        return SDModelConfig(
            clip=clip,
            unet=UNetConfig(
                block_out_channels=(32, 64),
                layers_per_block=1,
                num_attention_heads=4,
                cross_attention_dim=clip.hidden_size,
                norm_num_groups=8,
                down_block_has_attn=(False, True),
                transformer_depth=(0, 2),
                addition_embed_type="text_time",
                addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=48 + 5 * 8,
                sample_size=16,
            ),
            vae=VAEConfig.tiny(),
            xl_refiner=True,
        )

    @staticmethod
    def tiny(in_channels: int = 4) -> "SDModelConfig":
        clip = CLIPTextConfig.tiny()
        return SDModelConfig(
            clip=clip,
            unet=UNetConfig.tiny(in_channels, cross_attention_dim=clip.hidden_size),
            vae=VAEConfig.tiny(),
        )
