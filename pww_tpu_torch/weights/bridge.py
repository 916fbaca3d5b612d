"""Parameters for the port: from the JAX package's tree, or synthetic.

* :func:`params_from_jax` turns the JAX package's parameter tree (nested
  dicts of **numpy** arrays, flax paths) into the port's diffusers-keyed
  state dicts. It carries its own copy of the inverse of
  ``pww_tpu/weights/loader.py``'s ``unet_key``, ``clip_key`` and
  ``vae_keys``: flax ``(kh, kw, I, O)`` conv kernels become torch
  ``(O, I, kh, kw)`` and flax ``(in, out)`` dense kernels become
  ``(out, in)``. The VAE encoder is skipped: the port decodes only.
* :func:`synthetic_params` fills every float tensor of the port's modules
  with N(0, 0.02), drawn on the device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import SDModelConfig

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _leaf(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """flax leaf → (torch leaf name, torch-layout array)."""
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", np.transpose(arr, (1, 0))
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
    parts = []
    for m in path:
        mm = re.fullmatch(r"layers_(\d+)", m)
        parts.append(f"encoder.layers.{mm[1]}" if mm else m)
    return "text_model." + ".".join(parts)


_VAE_PATTERNS = (
    (r"up_(\d+)_resnet_(\d+)", "up_blocks.{}.resnets.{}"),
    (r"up_(\d+)_upsample", "up_blocks.{}.upsamplers.0.conv"),
    (r"mid_resnet_(\d+)", "mid_block.resnets.{}"),
)
_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
             "proj_out": "to_out.0"}


def vae_key(path: Tuple[str, ...]) -> str:
    """Decoder paths only; ``post_quant_conv`` sits at the top level."""
    if path[1] == "post_quant_conv":
        return "post_quant_conv"
    parts, in_attn = ["decoder"], False
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


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix if k == "params" else prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> StateDicts:
    """{"unet", "clip", "vae"} flax trees of numpy arrays → torch state dicts."""
    out: StateDicts = {"unet": {}, "clip": {}, "vae": {}}
    for part in out:
        for path, arr in _walk(tree[part]):
            *mods, leaf = path
            mods = tuple(mods)
            arr = np.asarray(arr)
            if part == "clip" and leaf == "position_embedding":
                key, t = "text_model.embeddings.position_embedding.weight", arr
            else:
                if part == "vae" and mods[0] == "encoder":
                    continue
                prefix = {"unet": unet_key, "clip": clip_key, "vae": vae_key}[part](mods)
                name, t = _leaf(leaf, arr)
                key = f"{prefix}.{name}"
            if key in out[part]:
                raise ValueError(f"duplicate key {key} from {path}")
            out[part][key] = torch.tensor(np.asarray(t))
    return out


def build_models(config: SDModelConfig, device="meta"):
    """The port's three modules, uninitialized on ``device``."""
    from ..models.clip import CLIPTextModel
    from ..models.unet import UNet2DConditionModel
    from ..models.vae import AutoencoderKL

    with torch.device(device):
        return {
            "unet": UNet2DConditionModel(config.unet),
            "clip": CLIPTextModel(config.clip),
            "vae": AutoencoderKL(config.vae),
        }


def synthetic_params(config: SDModelConfig, seed: int = 0, device="cuda",
                     dtype=torch.bfloat16) -> StateDicts:
    """N(0, 0.02) in every float tensor, in state-dict order, drawn on
    ``device`` from ``torch.Generator(device).manual_seed(seed)``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out: StateDicts = {}
    for part, module in build_models(config).items():
        sd = {}
        for key, ref in module.state_dict().items():
            x = torch.randn(ref.shape, generator=g, dtype=torch.float32, device=device)
            sd[key] = x.mul_(0.02).to(dtype)
        out[part] = sd
    return out
