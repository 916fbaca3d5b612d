"""CLIP vision tower and the IP-Adapter's image projections.

Port of :mod:`pww_tpu.models.clip_vision`:

* :class:`CLIPVisionEncoder`, transformers' ``CLIPVisionModelWithProjection``
  with its parameter names (``vision_model.embeddings.patch_embedding``,
  ``vision_model.pre_layrnorm``, …, ``visual_projection``): a patch conv
  without bias, the class token, position embeddings, ``pre_layrnorm``, the
  text tower's encoder layer without the causal mask, ``post_layernorm`` on
  the class token and the bias-free projection. LayerNorms compute in f32.
  It takes NCHW pixels, where the JAX module takes NHWC;
* :func:`preprocess_clip_image`, transformers' ``CLIPImageProcessor``:
  bicubic resize of the shortest edge, centre crop, CLIP mean and std;
* :class:`ImageProjection` (the standard adapter: the image embedding to N
  tokens) and :class:`Resampler` (the plus adapter: a perceiver over the
  penultimate patch states), whose state dicts carry the tencent-ailab
  checkpoint's ``image_proj.*`` names without the prefix. The Resampler's
  LayerNorms use flax's ε = 1e-6, as the JAX package does (ROADMAP C.12);
  ``ImageProjection``'s norm 1e-5.

None of these is a Pallas kernel in the JAX package; they stay plain
PyTorch here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPVisionConfig
from ..ops.attention import merge_heads, split_heads
from ..ops.layer_norm import layer_norm_f32
from .clip import CLIPEncoderLayer

# OpenAI's CLIP preprocessing constants (transformers CLIPImageProcessor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        dtype = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dtype))  # (B, D, g, g)
        x = x.flatten(2).transpose(1, 2)  # row-major patches, as the NHWC reshape
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]].to(dtype)


class CLIPVisionEncoderLayers(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal=False)
                                    for _ in range(cfg.num_layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)  # sic
        self.encoder = CLIPVisionEncoderLayers(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """(B, 3, H, W) pixels → ``image_embeds`` (B, projection_dim);
    ``output="hidden_and_pooled"`` returns the penultimate hidden states
    (B, 1 + patches, hidden), what the plus adapter's Resampler takes, and
    the embeddings."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor, output: str = "embeds"):
        if output not in ("embeds", "hidden_and_pooled"):
            raise ValueError(f"unknown output mode {output!r}")
        vm = self.vision_model
        x = layer_norm_f32(vm.pre_layrnorm, vm.embeddings(pixel_values))
        layers = vm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x)
        penultimate = x
        x = layers[-1](x)
        embeds = self.visual_projection(layer_norm_f32(vm.post_layernorm, x[:, 0]))
        return embeds if output == "embeds" else (penultimate, embeds)


def preprocess_clip_image(image, size: int = 224) -> torch.Tensor:
    """PIL image or (H, W, 3) array (uint8, or floats in [0, 1]) → (1, 3,
    size, size) f32 on the CPU: bicubic resize of the shortest edge to
    ``size``, centre crop, 1/255, CLIP mean and std, the JAX package's numpy
    arithmetic (``pww_tpu/models/clip_vision.py:101-130``) in NCHW."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        image = Image.fromarray(arr)
    image = image.convert("RGB")
    w, h = image.size
    if h <= w:
        nh, nw = size, int(size * w / h)
    else:
        nh, nw = int(size * h / w), size
    image = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    x = np.asarray(image, np.float32) / 255.0
    x = (x - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
    return torch.from_numpy(x.astype(np.float32).transpose(2, 0, 1)[None].copy())


class ImageProjection(nn.Module):
    """The standard adapter's projection: (B, embed_dim) image embeddings →
    (B, num_tokens, cross_attention_dim) tokens, a Linear then an f32
    LayerNorm (ε 1e-5), in the weights' dtype."""

    def __init__(self, cross_attention_dim: int, num_tokens: int = 4, embed_dim: int = 1024):
        super().__init__()
        self.num_tokens = num_tokens
        self.proj = nn.Linear(embed_dim, cross_attention_dim * num_tokens)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return layer_norm_f32(self.norm, x.reshape(x.shape[0], self.num_tokens, -1))


class PerceiverAttention(nn.Module):
    """Queries from the latents, keys and values from [features ; latents];
    dh^-¼ on both q and k, the products in f32 (tencent-ailab's
    formulation; the JAX package's scale is an f32 array, which promotes
    them, ``pww_tpu/models/clip_vision.py:158-192``)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 12, eps: float = 1e-6):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        xn = layer_norm_f32(self.norm1, x)
        ln = layer_norm_f32(self.norm2, latents)
        q = self.to_q(ln)
        k, v = self.to_kv(torch.cat([xn, ln], dim=-2)).chunk(2, dim=-1)
        q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
        scale = 1.0 / torch.tensor(float(self.dim_head)).sqrt().sqrt()
        w = torch.matmul(q.float() * scale, (k.float() * scale).transpose(-1, -2))
        out = torch.matmul(torch.softmax(w, dim=-1).to(v.dtype), v)
        return self.to_out(merge_heads(out))


class Resampler(nn.Module):
    """The plus adapter's projection: ``num_queries`` learned latents
    cross-attend the encoder's penultimate states over ``depth`` layers
    (``layers.{i}.0`` the attention, ``layers.{i}.1`` the LayerNorm, Linear,
    exact f32 GELU, Linear feed-forward), then ``proj_out`` and
    ``norm_out`` → (B, num_queries, output_dim)."""

    def __init__(self, dim: int, output_dim: int, num_queries: int = 16, depth: int = 4,
                 dim_head: int = 64, heads: int = 12, ff_mult: int = 4,
                 embedding_dim: int = 1280, eps: float = 1e-6):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads, eps), nn.Sequential(
                nn.LayerNorm(dim, eps=eps), nn.Linear(dim, dim * ff_mult, bias=False),
                nn.GELU(), nn.Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=eps)

    def forward(self, image_feats: torch.Tensor) -> torch.Tensor:
        dtype = self.proj_in.weight.dtype
        latents = self.latents.to(dtype).expand(image_feats.shape[0], -1, -1)
        x = self.proj_in(image_feats.to(dtype))
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            h = ff[1](layer_norm_f32(ff[0], latents))
            latents = latents + ff[3](F.gelu(h.float()).to(dtype))
        return layer_norm_f32(self.norm_out, self.proj_out(latents))

