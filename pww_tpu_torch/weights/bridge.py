"""Parameters for the port: from the JAX package's tree, or synthetic.

* :func:`params_from_jax` turns the JAX package's parameter tree (nested
  dicts of **numpy** arrays, flax paths) into the port's diffusers-keyed
  state dicts. It carries its own copy of the inverse of
  ``pww_tpu/weights/loader.py``'s ``unet_key``, ``clip_key`` and
  ``vae_keys``: flax ``(kh, kw, I, O)`` conv kernels become torch
  ``(O, I, kh, kw)`` and flax ``(in, out)`` dense kernels become
  ``(out, in)``. The VAE encoder and ``quant_conv`` come across with the
  decoder, and a 9-channel inpainting ``conv_in`` as any other conv.
  A ControlNet tree (part "controlnet") takes the inverse of
  ``controlnet_key`` (``pww_tpu/weights/loader.py:239-257``; an SDXL
  net's ``add_embedding`` keeps the UNet's names), and a
  T2I-Adapter tree (part "t2i_adapter") the inverse of
  ``pww_tpu/models/t2i_adapter.py``'s ``t2i_adapter_key``. SDXL's second
  text tower is part "clip2"; a projected tower's ``text_projection``
  sits at the top level, as in transformers' ``CLIPTextModelWithProjection``
  (``pww_tpu/weights/loader.py:172-176``). The IP-Adapter's trees: an
  ip-enabled UNet's ``to_k_ip``/``to_v_ip`` come across as any other dense
  kernel; part "image_encoder" (``CLIPVisionEncoder``) takes
  :func:`vision_key`, the inverse of ``pww_tpu/weights/ip_adapter.py``'s;
  parts "image_proj" (``ImageProjection``) and "resampler" (``Resampler``)
  take tencent-ailab's ``image_proj.*`` names (:func:`resampler_key`).
* :func:`synthetic_params` fills every float tensor of the port's modules
  with N(0, 0.02), drawn on the device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import SDModelConfig

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _leaf(leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """flax leaf → (torch leaf name, torch-layout tensor)."""
    if leaf == "kernel":
        if arr.dim() == 4:
            return "weight", arr.permute(3, 2, 0, 1).contiguous()
        if arr.dim() == 2:
            return "weight", arr.t().contiguous()
        return "weight", arr
    return {"bias": "bias", "scale": "weight", "embedding": "weight"}[leaf], arr


_UNET_PATTERNS = (
    (r"down_(\d+)_resnet_(\d+)", "down_blocks.{}.resnets.{}"),
    (r"down_(\d+)_attn_(\d+)", "down_blocks.{}.attentions.{}"),
    (r"down_(\d+)_downsample", "down_blocks.{}.downsamplers.0"),
    (r"up_(\d+)_resnet_(\d+)", "up_blocks.{}.resnets.{}"),
    (r"up_(\d+)_attn_(\d+)", "up_blocks.{}.attentions.{}"),
    (r"up_(\d+)_upsample", "up_blocks.{}.upsamplers.0"),
    (r"mid_resnet_(\d+)", "mid_block.resnets.{}"),
    (r"blocks_(\d+)", "transformer_blocks.{}"),
)


def _unet_module(name: str) -> str:
    for pat, fmt in _UNET_PATTERNS:
        m = re.fullmatch(pat, name)
        if m:
            return fmt.format(*m.groups())
    return {"mid_attn": "mid_block.attentions.0", "to_out": "to_out.0"}.get(name, name)


def unet_key(path: Tuple[str, ...]) -> str:
    """('down_0_attn_1', 'blocks_0', 'attn2', 'to_q') →
    'down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_q'."""
    parts = []
    for i, m in enumerate(path):
        if i > 0 and path[i - 1] == "ff":  # GEGLU naming
            parts.append({"proj_in": "net.0.proj", "proj_out": "net.2"}[m])
        else:
            parts.append(_unet_module(m))
    return ".".join(parts)


def clip_key(path: Tuple[str, ...]) -> str:
    if path and path[0] == "token_embedding":
        return "text_model.embeddings.token_embedding"
    if path and path[0] == "text_projection":
        return "text_projection"
    parts = []
    for m in path:
        mm = re.fullmatch(r"layers_(\d+)", m)
        parts.append(f"encoder.layers.{mm[1]}" if mm else m)
    return "text_model." + ".".join(parts)


_VAE_PATTERNS = (
    (r"down_(\d+)_resnet_(\d+)", "down_blocks.{}.resnets.{}"),
    (r"down_(\d+)_downsample", "down_blocks.{}.downsamplers.0.conv"),
    (r"up_(\d+)_resnet_(\d+)", "up_blocks.{}.resnets.{}"),
    (r"up_(\d+)_upsample", "up_blocks.{}.upsamplers.0.conv"),
    (r"mid_resnet_(\d+)", "mid_block.resnets.{}"),
)
_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
             "proj_out": "to_out.0"}


def vae_key(path: Tuple[str, ...]) -> str:
    """('encoder' | 'decoder', ...) flax paths; ``quant_conv`` (inside the
    flax encoder) and ``post_quant_conv`` (inside the flax decoder) sit at
    the top level of diffusers' AutoencoderKL."""
    if path[1] in ("quant_conv", "post_quant_conv"):
        return path[1]
    parts, in_attn = [path[0]], False
    for m in path[1:]:
        for pat, fmt in _VAE_PATTERNS:
            mm = re.fullmatch(pat, m)
            if mm:
                parts.append(fmt.format(*mm.groups()))
                break
        else:
            if m == "mid_attn":
                parts.append("mid_block.attentions.0")
                in_attn = True
            elif in_attn and m in _VAE_ATTN:
                parts.append(_VAE_ATTN[m])
            else:
                parts.append(m)
    return ".".join(parts)


def controlnet_key(path: Tuple[str, ...]) -> str:
    """('zero_conv_3', 'conv') → 'controlnet_down_blocks.3' (a ZeroConv wraps
    its conv in a module of its own); ('cond_embedding', 'blocks_2') →
    'controlnet_cond_embedding.blocks.2'; the encoder copy's paths as the
    UNet's."""
    m = re.fullmatch(r"zero_conv_(\d+)", path[0])
    if m:
        return f"controlnet_down_blocks.{m[1]}"
    if path[0] == "zero_conv_mid":
        return "controlnet_mid_block"
    if path[0] == "cond_embedding":
        m = re.fullmatch(r"blocks_(\d+)", path[1])
        return "controlnet_cond_embedding." + (f"blocks.{m[1]}" if m else path[1])
    return unet_key(path)


def t2i_adapter_key(path: Tuple[str, ...]) -> str:
    """('body_1', 'resnets_0', 'block2') → 'adapter.body.1.resnets.0.block2'."""
    parts = ["adapter"]
    for m in path:
        mm = re.fullmatch(r"(body|resnets)_(\d+)", m)
        parts.append(f"{mm[1]}.{mm[2]}" if mm else m)
    return ".".join(parts)


def vision_key(path: Tuple[str, ...]) -> str:
    """('layers_3', 'self_attn', 'q_proj') →
    'vision_model.encoder.layers.3.self_attn.q_proj'; transformers'
    ``pre_layrnorm`` keeps its typo."""
    if path[0] == "visual_projection":
        return "visual_projection"
    if path[0] == "patch_embedding":
        return "vision_model.embeddings.patch_embedding"
    parts = []
    for m in path:
        mm = re.fullmatch(r"layers_(\d+)", m)
        parts.append(f"encoder.layers.{mm[1]}" if mm else
                     "pre_layrnorm" if m == "pre_layernorm" else m)
    return "vision_model." + ".".join(parts)


_RESAMPLER_PATTERNS = ((r"layers_(\d+)_attn", "layers.{}.0"),
                       (r"layers_(\d+)_ff_norm", "layers.{}.1.0"),
                       (r"layers_(\d+)_ff_in", "layers.{}.1.1"),
                       (r"layers_(\d+)_ff_out", "layers.{}.1.3"))


def resampler_key(path: Tuple[str, ...]) -> str:
    """('layers_1_ff_in',) → 'layers.1.1.1' (tencent-ailab's layout:
    ``layers.{i}.0`` the attention, ``layers.{i}.1`` the LayerNorm, Linear,
    GELU, Linear feed-forward)."""
    parts = []
    for m in path:
        for pat, fmt in _RESAMPLER_PATTERNS:
            mm = re.fullmatch(pat, m)
            if mm:
                parts.append(fmt.format(mm[1]))
                break
        else:
            parts.append(m)
    return ".".join(parts)


# the JAX package's conditioning embedding ends in a 1×1 conv where
# diffusers' (and the port's) has a 3×3 one (ROADMAP C.8)
COND_EMBEDDING_OUT = "controlnet_cond_embedding.conv_out.weight"


def centre_tap(kernel: torch.Tensor) -> torch.Tensor:
    """A 1×1 conv kernel as the centre of a zero 3×3 one: with padding 1 the
    same function."""
    out = kernel.new_zeros((*kernel.shape[:2], 3, 3))
    out[:, :, 1, 1] = kernel[:, :, 0, 0]
    return out


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix if k == "params" else prefix + (k,))
        else:
            yield prefix + (k,), v


_KEYS = {"unet": unet_key, "clip": clip_key, "clip2": clip_key, "vae": vae_key,
         "controlnet": controlnet_key, "t2i_adapter": t2i_adapter_key,
         "image_encoder": vision_key, "image_proj": ".".join, "resampler": resampler_key}
# parameters that are flax leaves of their own, not a module's kernel or scale
_PARAM_LEAVES = {
    ("clip", "position_embedding"): "text_model.embeddings.position_embedding.weight",
    ("clip2", "position_embedding"): "text_model.embeddings.position_embedding.weight",
    ("image_encoder", "class_embedding"): "vision_model.embeddings.class_embedding",
    ("image_encoder", "position_embedding"): "vision_model.embeddings.position_embedding.weight",
    ("resampler", "latents"): "latents",
}


def params_from_jax(tree) -> StateDicts:
    """{part: flax tree of numpy arrays or CPU tensors} → {part: torch state
    dict}, for the parts "unet", "clip", "clip2", "vae", "controlnet",
    "t2i_adapter", "image_encoder", "image_proj" and "resampler" in
    ``tree``."""
    out: StateDicts = {}
    for part, sub in tree.items():
        sd = out[part] = {}
        for path, arr in _walk(sub):
            *mods, leaf = path
            mods = tuple(mods)
            if not isinstance(arr, torch.Tensor):
                arr = torch.tensor(np.asarray(arr))
            if (part, leaf) in _PARAM_LEAVES and not mods:
                key, t = _PARAM_LEAVES[part, leaf], arr
            else:
                name, t = _leaf(leaf, arr)
                key = f"{_KEYS[part](mods)}.{name}"
            if key in sd:
                raise ValueError(f"duplicate key {key} from {path}")
            sd[key] = t
        if part == "controlnet":
            sd[COND_EMBEDDING_OUT] = centre_tap(sd[COND_EMBEDDING_OUT])
    return out


PARTS = ("unet", "clip", "vae")


def pipeline_parts(config: SDModelConfig) -> Tuple[str, ...]:
    """The parts a pipeline of ``config`` holds: SDXL-base adds "clip2"."""
    return PARTS + ("clip2",) if config.is_xl else PARTS


def build_models(config: SDModelConfig, device="meta", parts=None):
    """The port's modules for ``parts`` (default :func:`pipeline_parts`),
    uninitialized on ``device``: "unet", "clip", "clip2" (SDXL-base's
    second tower), "vae", "controlnet" (for ``config.unet``) and
    "t2i_adapter" (a full adapter for ``config.unet``'s blocks, 2 residual
    blocks per stage, an RGB hint)."""
    from ..models.clip import CLIPTextModel
    from ..models.controlnet import ControlNetModel
    from ..models.t2i_adapter import T2IAdapter
    from ..models.unet import UNet2DConditionModel
    from ..models.vae import AutoencoderKL

    builders = {
        "unet": lambda: UNet2DConditionModel(config.unet),
        "clip": lambda: CLIPTextModel(config.clip),
        "clip2": lambda: CLIPTextModel(config.clip2),
        "vae": lambda: AutoencoderKL(config.vae),
        # a ControlNet takes no image-prompt tokens (pww_tpu/pipeline/pipeline.py:60-63)
        "controlnet": lambda: ControlNetModel(dataclasses.replace(config.unet,
                                                                  ip_adapter_tokens=None)),
        "t2i_adapter": lambda: T2IAdapter(config.unet.block_out_channels,
                                          downscale_factor=config.vae.scale_factor),
    }
    parts = parts or pipeline_parts(config)
    with torch.device(device):
        return {part: builders[part]() for part in parts}


def synthetic_state(module: torch.nn.Module, generator: torch.Generator,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """N(0, 0.02) in every tensor of ``module``'s state dict, in its order,
    drawn on the generator's device."""
    sd = {}
    for key, ref in module.state_dict().items():
        x = torch.randn(ref.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        sd[key] = x.mul_(0.02).to(dtype)
    return sd


def synthetic_params(config: SDModelConfig, seed: int = 0, device="cuda",
                     dtype=torch.bfloat16, parts=None) -> StateDicts:
    """N(0, 0.02) in every float tensor of each part, in state-dict order,
    drawn on ``device`` from ``torch.Generator(device).manual_seed(seed)``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return {part: synthetic_state(module, g, dtype)
            for part, module in build_models(config, parts=parts).items()}
