"""IP-Adapter checkpoints (Ye et al. 2023, the tencent-ailab layout).

Port of :mod:`pww_tpu.weights.ip_adapter`. An ``ip-adapter*.safetensors``
holds two groups:

- ``image_proj.*``: the standard adapter's projection of the CLIP image
  embedding to N tokens (``proj``, ``norm``), or the plus adapter's
  Resampler (``latents``, ``proj_in``, ``layers.{i}.{0,1}``, ``proj_out``,
  ``norm_out``);
- ``ip_adapter.{i}.to_k_ip.weight`` / ``.to_v_ip.weight``, keyed by the
  index of the attention processor in diffusers' ``unet.attn_processors``,
  which follows module registration order: down blocks, then UP blocks,
  then the mid block, attn1 before attn2 in each transformer block, so the
  cross-attention site i carries index 2i + 1 (:func:`attn2_sites`).

The published ``.bin`` files hold those groups as nested dicts
(``{"image_proj": {...}, "ip_adapter": {...}}``). The JAX package's reader
keeps top-level tensors only, so such a file reaches its parser empty and
fails on ``proj.weight``; the port refuses it by name (ROADMAP C.13).
A plus file's ``latents`` are (1, Q, D) as tencent-ailab and diffusers
store them, which the JAX ``resampler_config`` cannot unpack; the port
takes them as (Q, D) (ROADMAP C.16).

The image encoder is a transformers ``CLIPVisionModelWithProjection``
directory (``config.json`` and ``model.safetensors`` or
``pytorch_model.bin``): :func:`load_image_encoder` reads it and
:func:`save_image_encoder` writes one.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

from ..config import CLIPVisionConfig, UNetConfig
from . import safetensors_io
from .bridge import unet_key, vision_key  # noqa: F401  (vision_key: the package's name)
from .loader import _find_weights_file, convert_state_dict, read_state_dict
from .lora import _f32

IP_LEAVES = ("to_k_ip.weight", "to_v_ip.weight")


def attn2_sites(cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(site module, transformer block) pairs, in the JAX package's names,
    in diffusers' attention-processor order: down blocks, UP blocks, then
    mid."""
    sites: List[Tuple[str, str]] = []
    n_blocks = len(cfg.block_out_channels)

    def add(site: str, depth: int) -> None:
        sites.extend((site, f"blocks_{d}") for d in range(depth))

    for bi in range(n_blocks):
        if cfg.down_block_has_attn[bi]:
            for li in range(cfg.layers_per_block):
                add(f"down_{bi}_attn_{li}", cfg.depth_for(bi))
    for bi in range(n_blocks):
        if cfg.up_block_has_attn[bi]:
            for li in range(cfg.layers_per_block + 1):
                add(f"up_{bi}_attn_{li}", cfg.depth_for(n_blocks - 1 - bi))
    add("mid_attn", cfg.depth_for(n_blocks - 1))
    return sites


def site_module(site: str, block: str) -> str:
    """A site of :func:`attn2_sites` → the port's attn2 module path."""
    return unet_key((site, block, "attn2"))


def parse_ip_adapter_state(state: Dict):
    """A flat checkpoint → (the ``image_proj`` group, {site index: {leaf:
    tensor}}), f32 tensors on the CPU; any other key raises."""
    proj: Dict[str, torch.Tensor] = {}
    sites: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, val in state.items():
        if key.startswith("image_proj."):
            proj[key[len("image_proj."):]] = _f32(val)
        elif key.startswith("ip_adapter."):
            idx_s, leaf = key[len("ip_adapter."):].split(".", 1)
            sites.setdefault(int(idx_s), {})[leaf] = _f32(val)
        else:
            raise ValueError(f"unrecognized ip-adapter key {key!r}")
    return proj, sites


def load_ip_adapter_file(path: str):
    """A flat ``.safetensors`` or ``.bin`` IP-Adapter → its two groups; a
    ``.bin`` holding the nested tencent-ailab dicts raises ``ValueError``."""
    if not path.endswith(".safetensors"):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        nested = sorted(k for k, v in raw.items() if isinstance(v, dict))
        if nested:
            raise ValueError(
                f"{path}: the IP-Adapter groups {nested} are nested dicts (the published "
                "tencent-ailab .bin layout), which the reference's reader drops (ROADMAP "
                "C.13); use the flat .safetensors layout, keys image_proj.* and ip_adapter.*")
    return parse_ip_adapter_state(read_state_dict(path))


def num_tokens_from_proj(proj: Dict[str, torch.Tensor], cross_attention_dim: int) -> int:
    return proj["proj.weight"].shape[0] // cross_attention_dim


def image_proj_params(proj: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The standard ``image_proj`` group → ``ImageProjection``'s state dict
    (the names are the module's already)."""
    return {k: proj[k] for k in ("proj.weight", "proj.bias", "norm.weight", "norm.bias")}


def is_plus_format(proj: Dict[str, torch.Tensor]) -> bool:
    return "latents" in proj


def _latents(proj: Dict[str, torch.Tensor]) -> torch.Tensor:
    lat = proj["latents"]
    if lat.dim() == 3 and lat.shape[0] == 1:  # tencent-ailab's (1, Q, D)
        lat = lat[0]
    if lat.dim() != 2:
        raise ValueError(f"ip-adapter-plus latents of shape {tuple(proj['latents'].shape)}")
    return lat


def _depth(proj: Dict[str, torch.Tensor]) -> int:
    depth = 0
    while f"layers.{depth}.0.to_q.weight" in proj:
        depth += 1
    return depth


def resampler_params(proj: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The plus ``image_proj`` group → ``Resampler``'s state dict (the
    latents as (Q, D))."""
    return {**proj, "latents": _latents(proj)}


def resampler_config(proj: Dict[str, torch.Tensor]) -> dict:
    """The Resampler's hyperparameters from the checkpoint's shapes, as the
    JAX package derives them (head width 64)."""
    num_queries, dim = _latents(proj).shape
    inner = proj["layers.0.0.to_q.weight"].shape[0]
    return dict(dim=dim, output_dim=proj["proj_out.weight"].shape[0],
                num_queries=num_queries, depth=_depth(proj), dim_head=64,
                heads=inner // 64, ff_mult=proj["layers.0.1.1.weight"].shape[0] // dim)


def install_ip_adapter(unet_state: Dict[str, torch.Tensor], expected: Dict[str, torch.Tensor],
                       cfg: UNetConfig, sites_state: Dict[int, Dict[str, torch.Tensor]]):
    """The ip-enabled UNet's state dict: ``unet_state``'s tensors and each
    attn2 site's ``to_k_ip``/``to_v_ip`` from the checkpoint (site i ↔ index
    2i + 1), for the module whose state dict is ``expected``. Raises
    ``KeyError`` when a site has no entry or an entry no site, and
    ``ValueError`` on a shape that differs."""
    order = attn2_sites(cfg)
    by_module = {}
    for i, (site, block) in enumerate(order):
        idx = 2 * i + 1
        if idx not in sites_state:
            raise KeyError(f"ip-adapter checkpoint has no entry {idx} for site {site}/{block} "
                           f"({len(sites_state)} entries present)")
        by_module[site_module(site, block)] = sites_state[idx]
    extra = set(sites_state) - {2 * i + 1 for i in range(len(order))}
    if extra:
        raise KeyError(f"ip-adapter checkpoint entries {sorted(extra)} have no matching "
                       f"attention site (model has {len(order)} cross-attention sites)")
    out = {}
    for key, ref in expected.items():
        module, _, leaf = key.rpartition(".")
        module, _, name = module.rpartition(".")
        if f"{name}.{leaf}" not in IP_LEAVES:
            out[key] = unet_state[key]
            continue
        t = by_module[module][f"{name}.{leaf}"]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"ip-adapter shape mismatch at {key}: checkpoint "
                             f"{tuple(t.shape)} vs model {tuple(ref.shape)}")
        out[key] = t
    return out


def _vision_config(d: dict) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        hidden_size=d.get("hidden_size", 1280),
        intermediate_size=d.get("intermediate_size", 5120),
        num_layers=d.get("num_hidden_layers", 32),
        num_heads=d.get("num_attention_heads", 16),
        image_size=d.get("image_size", 224),
        patch_size=d.get("patch_size", 14),
        hidden_act=d.get("hidden_act", "gelu"),
        projection_dim=d.get("projection_dim", 1024),
    )


def load_image_encoder(path: str):
    """A transformers ``CLIPVisionModelWithProjection`` directory → (config,
    state dict of tensors in their stored type)."""
    from ..models.clip_vision import CLIPVisionEncoder

    with open(os.path.join(path, "config.json")) as f:
        cfg = _vision_config(json.load(f))
    with torch.device("meta"):
        expected = CLIPVisionEncoder(cfg).state_dict()
    state = read_state_dict(_find_weights_file(path))
    return cfg, convert_state_dict("image_encoder", state, expected)


def save_image_encoder(path: str, cfg: CLIPVisionConfig, state: Dict[str, torch.Tensor]) -> None:
    """Write ``state`` as a transformers image-encoder directory that
    :func:`load_image_encoder` (and the JAX package's) reads: ``config.json``
    and ``model.safetensors`` in the tensors' own type, one at a time."""
    os.makedirs(path, exist_ok=True)
    d = {"architectures": ["CLIPVisionModelWithProjection"], "hidden_size": cfg.hidden_size,
         "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
         "num_attention_heads": cfg.num_heads, "image_size": cfg.image_size,
         "patch_size": cfg.patch_size, "hidden_act": cfg.hidden_act,
         "projection_dim": cfg.projection_dim, "layer_norm_eps": cfg.layer_norm_eps}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f, indent=1)
    safetensors_io.save_file({k: t.detach() for k, t in state.items()},
                             os.path.join(path, "model.safetensors"))
