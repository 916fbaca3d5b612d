"""Checkpoint loading: a diffusers-layout SD directory → the port's state dicts.

Port of :mod:`pww_tpu.weights.loader` for the families the port has: SD-1.x
(4-channel), SD-1.x inpainting (9-channel ``conv_in``), SD-2.x (head dim
64, OpenCLIP-H text tower, v-prediction) and SDXL: the base's layout adds
``text_encoder_2/`` (a ``CLIPTextModelWithProjection``) and ``tokenizer_2/``,
the refiner's has those alone, without ``text_encoder/`` and ``tokenizer/``
(``pww_tpu/weights/loader.py:381-470, 600-650``). The port's modules carry
diffusers' and transformers' parameter names, so most keys load unchanged;
the exceptions, which the JAX package handles in ``fill_params`` and
``vae_keys``:

* SD-2.x's ``use_linear_projection`` stores a Transformer2D's ``proj_in``
  and ``proj_out`` as ``(O, I)`` Linear weights; the port's are 1×1 convs,
  so those weights gain two unit dims;
* older VAEs name the mid attention ``query``/``key``/``value``/
  ``proj_attn``, which become ``to_q``/``to_k``/``to_v``/``to_out.0``;
* buffers that are not parameters (``text_model.embeddings.position_ids``)
  are dropped.

:func:`load_pipeline_checkpoint` also reads one A1111/LDM ``.ckpt`` or
``.safetensors`` file (:mod:`.ldm_convert`) and a directory that the JAX
package's ``save_pretrained`` or converter CLI wrote (``params.msgpack``,
decoded by :mod:`.msgpack_io`, and ``config.json``).
ControlNet checkpoints (a diffusers ``ControlNetModel`` directory or one
file) load through :func:`load_controlnet_checkpoint`, T2I-Adapter state
dicts (bare or ``adapter.``-prefixed keys) through
:func:`t2i_adapter_state_dict`; :func:`save_controlnet_checkpoint` writes
the former, SDXL's (``addition_embed_type: "text_time"``, with its
``add_embedding`` and diffusers' 3×3 ``conv_out``) included: the JAX
reader raises on every such file, since its ``eval_shape`` passes no
``added_cond`` (``pww_tpu/weights/loader.py:266-274``; ROADMAP C.19).

A parameter missing from the checkpoint raises ``KeyError`` naming the
first few; any other key left over makes the pipeline's
``load_state_dict(strict=True)`` raise. ``.safetensors`` files are read by
:mod:`.safetensors_io` (no ``safetensors`` package), ``.bin`` files by
``torch.load(weights_only=True)``. Tensors keep their stored type; the
pipeline casts them to its own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional

import torch

from ..config import CLIPTextConfig, SchedulerConfig, SDModelConfig, UNetConfig, VAEConfig
from . import safetensors_io
from .bridge import (COND_EMBEDDING_OUT, StateDicts, build_models, centre_tap,
                     params_from_jax, pipeline_parts)

WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
)
_OLD_VAE_ATTN = re.compile(
    r"^((?:encoder|decoder)\.mid_block\.attentions\.0)\.(query|key|value|proj_attn)\.")
_NEW_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def read_state_dict(path: str, return_meta: bool = False):
    """One checkpoint file → {key: CPU tensor}; with ``return_meta`` also the
    header fields the tensor filter drops (``global_step`` of a ``.bin``)."""
    if path.endswith(".safetensors"):
        state = safetensors_io.load_file(path)
        return (state, {}) if return_meta else state
    sd = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if "global_step" in sd:
        try:
            meta["global_step"] = int(sd["global_step"])
        except (TypeError, ValueError):
            pass
    if "state_dict" in sd:
        sd = sd["state_dict"]
    state = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return (state, meta) if return_meta else state


def _find_weights_file(subdir: str) -> str:
    for name in WEIGHT_FILES:
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights file in {subdir}")


def _read_json(path: str) -> Optional[dict]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def _clip_config(d: dict, default_act: str = "quick_gelu") -> CLIPTextConfig:
    """A text tower's ``config.json``; the projection head only for a
    ``CLIPTextModelWithProjection``."""
    with_projection = d.get("architectures", [""])[0] == "CLIPTextModelWithProjection"
    return CLIPTextConfig(
        vocab_size=d.get("vocab_size", 49408),
        hidden_size=d.get("hidden_size", 768),
        intermediate_size=d.get("intermediate_size", 3072),
        num_layers=d.get("num_hidden_layers", 12),
        num_heads=d.get("num_attention_heads", 12),
        max_position_embeddings=d.get("max_position_embeddings", 77),
        hidden_act=d.get("hidden_act", default_act),
        projection_dim=d.get("projection_dim") if with_projection else None,
        eos_token_id=d.get("eos_token_id", 49407),
    )


def config_from_checkpoint(model_path: str) -> SDModelConfig:
    """The model config from the directory's ``unet/``, ``text_encoder/``,
    ``text_encoder_2/`` and ``vae/`` ``config.json`` files and
    ``model_index.json``, with the JAX package's defaults for what they
    leave out. A ``text_encoder_2/`` without ``text_encoder/`` is the
    SDXL-refiner layout (``xl_refiner``, the bigG tower in the ``clip``
    slot). An LCM-distilled UNet's ``time_cond_proj_dim`` is read as any
    other field."""
    unet_cfg = _read_json(os.path.join(model_path, "unet", "config.json")) or {}
    clip_cfg = _read_json(os.path.join(model_path, "text_encoder", "config.json"))
    clip2_cfg = _read_json(os.path.join(model_path, "text_encoder_2", "config.json"))
    vae_cfg = _read_json(os.path.join(model_path, "vae", "config.json")) or {}

    # diffusers' "attention_head_dim" holds per-block HEAD COUNTS: an int (8
    # for SD-1.x) or a list ([5, 10, 20, 20] for SD-2.x, where dh = 64)
    blocks = tuple(unet_cfg.get("block_out_channels", (320, 640, 1280, 1280)))
    ahd = unet_cfg.get("attention_head_dim", 8)
    if isinstance(ahd, (list, tuple)):
        num_heads, head_dim = 8, blocks[0] // ahd[0]
    else:
        num_heads, head_dim = ahd, None
    depth = unet_cfg.get("transformer_layers_per_block")
    if isinstance(depth, int):
        depth = (depth,) * len(blocks)
    unet = UNetConfig(
        in_channels=unet_cfg.get("in_channels", 4),
        out_channels=unet_cfg.get("out_channels", 4),
        sample_size=unet_cfg.get("sample_size", 64),
        block_out_channels=blocks,
        layers_per_block=unet_cfg.get("layers_per_block", 2),
        num_attention_heads=num_heads,
        attention_head_dim=head_dim,
        prediction_type=unet_cfg.get("prediction_type", "epsilon"),
        cross_attention_dim=unet_cfg.get("cross_attention_dim", 768),
        norm_num_groups=unet_cfg.get("norm_num_groups", 32),
        down_block_has_attn=tuple(
            t == "CrossAttnDownBlock2D"
            for t in unet_cfg.get("down_block_types",
                                  ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",))
        ),
        transformer_depth=None if depth is None else tuple(depth),
        addition_embed_type=unet_cfg.get("addition_embed_type"),
        addition_time_embed_dim=unet_cfg.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=unet_cfg.get(
            "projection_class_embeddings_input_dim"),
        time_cond_proj_dim=unet_cfg.get("time_cond_proj_dim"),
    )
    xl_refiner = clip_cfg is None and clip2_cfg is not None
    if xl_refiner:
        clip, clip2 = _clip_config(clip2_cfg, "gelu"), None
    else:
        clip = _clip_config(clip_cfg or {})
        clip2 = None if clip2_cfg is None else _clip_config(clip2_cfg, "gelu")
    vae = VAEConfig(
        latent_channels=vae_cfg.get("latent_channels", 4),
        block_out_channels=tuple(vae_cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vae_cfg.get("layers_per_block", 2),
        norm_num_groups=vae_cfg.get("norm_num_groups", 32),
        scaling_factor=vae_cfg.get("scaling_factor", 0.18215),
    )
    index = _read_json(os.path.join(model_path, "model_index.json")) or {}
    return SDModelConfig(
        clip=clip, unet=unet, vae=vae, clip2=clip2,
        force_zeros_for_empty_prompt=index.get("force_zeros_for_empty_prompt", True),
        xl_refiner=xl_refiner)


def convert_state_dict(part: str, state: Dict[str, torch.Tensor],
                       expected: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict → the port's keys and layouts for module
    ``part`` ("unet", "clip", "clip2", "vae", "controlnet" or "t2i_adapter"), whose
    state dict (on any device, the meta device too) is ``expected``."""
    out = {}
    for key, t in state.items():
        if key.endswith(".position_ids"):
            continue  # a buffer, not a parameter
        if part == "vae":
            key = _OLD_VAE_ATTN.sub(lambda m: f"{m[1]}.{_NEW_VAE_ATTN[m[2]]}.", key)
        ref = expected.get(key)
        if ref is not None and t.dim() == 2 and ref.dim() == 4 and ref.shape[2:] == (1, 1):
            t = t[:, :, None, None]  # Linear proj_in/proj_out → 1×1 conv
        if ref is not None and tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{part}: shape mismatch at {key}: checkpoint "
                             f"{tuple(t.shape)} vs model {tuple(ref.shape)}")
        out[key] = t
    missing = [k for k in expected if k not in out]
    if missing:
        raise KeyError(f"{part}: {len(missing)} params missing from checkpoint: "
                       + "; ".join(missing[:8]))
    return out


# The JAX configs' fields that the port drops (ROADMAP "Not ported": knobs
# that only shaped TPU code), and those it takes per call or has not ported,
# which a JAX-written config may hold at their off values only.
JAX_ONLY_DROPPED = {"unet": ("xattn_block_q", "flash_block", "flash_pad_heads",
                             "conv_lowering", "xattn_variant")}
JAX_ONLY_OFF = {"unet": {"tome_ratio": (0.0, "generate(tome_ratio=...)"),
                         "freeu": (None, "generate(freeu=...)"),
                         "sow_mid_attn": (False, "generate(sag_scale=...)")}}
# Fields the port has, refused at any other value in a JAX-written directory.
# The JAX package's save_pretrained (pww_tpu/pipeline/pipeline.py:751-775)
# writes an IP-Adapter's to_k_ip/to_v_ip and ip_adapter_tokens but not the
# adapter's image projection or encoder, and its own from_pretrained cannot
# load the directory (the UNet's init traces without an IpState and raises);
# ROADMAP C.14.
JAX_REFUSED = {"unet": {"ip_adapter_tokens": (
    None, "the directory was saved with an IP-Adapter attached, and the JAX package's "
    "save_pretrained writes its to_k_ip/to_v_ip but not its image projection, so neither "
    "package can run it (ROADMAP C.14); save the pipeline without the adapter and attach "
    "it with PwwPipeline.load_ip_adapter")}}
_TUPLE_FIELDS = ("block_out_channels", "down_block_has_attn", "transformer_depth")


def _config_part(cls, part: str, fields: dict, where: str):
    """One JAX config dataclass from ``config.json`` as the port's ``cls``."""
    known = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for name, value in fields.items():
        if name in JAX_REFUSED.get(part, {}):
            off, why = JAX_REFUSED[part][name]
            if value != off:
                raise ValueError(f"{where}: {part}.{name}={value!r}: {why}")
        if name in known:
            kept[name] = tuple(value) if name in _TUPLE_FIELDS and value is not None else value
        elif name in JAX_ONLY_DROPPED.get(part, ()):
            continue
        elif name in JAX_ONLY_OFF.get(part, {}):
            off, instead = JAX_ONLY_OFF[part][name]
            if value != off:
                raise NotImplementedError(
                    f"{where}: {part}.{name}={value!r} is not a config field of "
                    f"pww_tpu_torch; use {instead}")
        else:
            raise ValueError(f"{where}: unknown {part} config field {name!r}")
    return cls(**kept)


def native_config(meta: dict, where: str = "config.json") -> SDModelConfig:
    """``config.json``'s ``"model"`` (``dataclasses.asdict`` of the JAX
    ``SDModelConfig``) as the port's config: the TPU-only fields dropped,
    the per-call ones taken at their off values, any other field the port
    lacks refused (:data:`JAX_ONLY_DROPPED`, :data:`JAX_ONLY_OFF`); an
    IP-Adapter's ``ip_adapter_tokens`` refused with its reason
    (:data:`JAX_REFUSED`)."""
    m = dict(meta["model"])
    parts = {"clip": CLIPTextConfig, "clip2": CLIPTextConfig, "unet": UNetConfig,
             "vae": VAEConfig, "scheduler": SchedulerConfig}
    for part, cls in parts.items():
        if m.get(part) is not None:
            m[part] = _config_part(cls, part, m[part], where)
    return _config_part(SDModelConfig, "model", m, where)


def _load_native_checkpoint(model_path: str):
    """A directory the JAX package wrote (``pww_tpu/weights/loader.py:
    470-561``): ``params.msgpack`` (the flax trees, through
    :func:`~.bridge.params_from_jax`), ``config.json`` and the tokenizers'
    files (the toy tokenizer where there are none)."""
    from ..tokenizer.clip_bpe import CLIPTokenizer, toy_tokenizer
    from . import msgpack_io

    cj = os.path.join(model_path, "config.json")
    with open(cj) as f:
        config = native_config(json.load(f), cj)
    tree = msgpack_io.load_file(os.path.join(model_path, "params.msgpack"))
    parts = pipeline_parts(config)
    if set(tree) != set(parts):
        raise ValueError(f"{model_path}: params.msgpack holds {sorted(tree)}, the config's "
                         f"pipeline {sorted(parts)}")
    state = params_from_jax(tree)
    params: StateDicts = {part: convert_state_dict(part, state[part], module.state_dict())
                          for part, module in build_models(config).items()}
    try:
        tokenizer = CLIPTokenizer.from_dir(model_path)
    except FileNotFoundError:
        tokenizer = toy_tokenizer(config.clip.vocab_size)
    tokenizer_2 = None
    if config.is_xl:
        t2dir = os.path.join(model_path, "tokenizer_2")
        tokenizer_2 = CLIPTokenizer.from_dir(t2dir) if os.path.isdir(t2dir) else tokenizer
    return config, params, tokenizer, tokenizer_2


def load_pipeline_checkpoint(model_path: str):
    """(config, {"unet", "clip", "vae"} state dicts, tokenizer, tokenizer_2)
    from a checkpoint, dispatched as the JAX loader does
    (``pww_tpu/weights/loader.py:564-580``): a file goes to
    :func:`~.ldm_convert.load_ldm_checkpoint` (``tokenizer_2`` None), a
    directory with ``params.msgpack`` to the JAX-written format's reader,
    anything else is a diffusers-layout directory: ``unet/``, ``text_encoder/`` and
    ``vae/`` each with a ``config.json`` and one of :data:`WEIGHT_FILES`, and
    the tokenizer's ``vocab.json`` / ``merges.txt`` in ``tokenizer/`` or at
    the top. SDXL-base adds "clip2" from ``text_encoder_2/`` and
    ``tokenizer_2`` from ``tokenizer_2/`` (the first tokenizer where that is
    missing); the refiner's one tower and tokenizer come from
    ``text_encoder_2/`` and ``tokenizer_2/``. A second tokenizer of its own
    pads with 0, OpenCLIP's "!" (``pww_tpu/weights/loader.py:624-650``).
    ``tokenizer_2`` is None for a model of one tower."""
    from ..tokenizer.clip_bpe import CLIPTokenizer

    if os.path.isfile(model_path):
        from .ldm_convert import load_ldm_checkpoint

        return (*load_ldm_checkpoint(model_path), None)
    if os.path.exists(os.path.join(model_path, "params.msgpack")):
        return _load_native_checkpoint(model_path)
    config = config_from_checkpoint(model_path)
    params: StateDicts = {}
    subdirs = {"unet": "unet", "clip": "text_encoder_2" if config.xl_refiner else "text_encoder",
               "clip2": "text_encoder_2", "vae": "vae"}
    for part, module in build_models(config).items():  # meta device: shapes only
        state = read_state_dict(_find_weights_file(os.path.join(model_path, subdirs[part])))
        params[part] = convert_state_dict(part, state, module.state_dict())
    t2dir = os.path.join(model_path, "tokenizer_2")
    if config.xl_refiner and os.path.isdir(t2dir) and \
            not os.path.isdir(os.path.join(model_path, "tokenizer")):
        tokenizer = CLIPTokenizer.from_dir(t2dir)
        tokenizer.pad_token_id = 0
    else:
        tokenizer = CLIPTokenizer.from_dir(model_path)
    tokenizer_2 = None
    if config.is_xl:
        tokenizer_2 = tokenizer
        if os.path.isdir(t2dir):
            tokenizer_2 = CLIPTokenizer.from_dir(t2dir)
            tokenizer_2.pad_token_id = 0
    return config, params, tokenizer, tokenizer_2


def load_controlnet_checkpoint(path: str, config: SDModelConfig) -> Dict[str, torch.Tensor]:
    """A diffusers ControlNet directory (``config.json`` and one of
    :data:`WEIGHT_FILES`) or a single ``.safetensors``/``.bin`` file → the
    port's ControlNet state dict for ``config`` (``pww_tpu/weights/loader.py:
    260-278``). The conditioning embedding's ``conv_out`` may be diffusers'
    3×3 kernel or the JAX package's 1×1 one (ROADMAP C.8). An SDXL
    (``text_time``) ControlNet loads for an SDXL config (ROADMAP C.19: the
    JAX reader cannot load one); a directory whose ``addition_embed_type``
    is not the config's raises ``ValueError``."""
    if os.path.isdir(path):
        cn_cfg = _read_json(os.path.join(path, "config.json")) or {}
        kind = cn_cfg.get("addition_embed_type")
        if kind != config.unet.addition_embed_type:
            raise ValueError(f"{path}: a ControlNet with addition_embed_type={kind!r} for a "
                             f"UNet with {config.unet.addition_embed_type!r}")
        path = _find_weights_file(path)
    state = dict(read_state_dict(path))
    t = state.get(COND_EMBEDDING_OUT)
    if t is not None and tuple(t.shape[2:]) == (1, 1):
        state[COND_EMBEDDING_OUT] = centre_tap(t)
    expected = build_models(config, parts=("controlnet",))["controlnet"].state_dict()
    return convert_state_dict("controlnet", state, expected)


def t2i_adapter_state_dict(source, expected: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A T2I-Adapter checkpoint (a ``.safetensors``/``.bin`` path or a state
    dict of tensors or arrays) with diffusers' keys, bare or under
    ``adapter.`` (``pww_tpu/pipeline/pipeline.py:852-854``), → the port's
    state dict, checked against the module's ``expected`` one."""
    if isinstance(source, dict):
        state = {k: torch.as_tensor(v) for k, v in source.items()}
    else:
        state = read_state_dict(source)
    if not any(k.startswith("adapter.") for k in state):
        state = {f"adapter.{k}": v for k, v in state.items()}
    return convert_state_dict("t2i_adapter", state, expected)


def recorded_scheduler(model_path: str) -> str:
    """The ``scheduler_type`` a directory's top-level ``config.json``
    records (both packages' ``save_pretrained`` and converters write it),
    else "lms", as for a single file."""
    cj = os.path.join(model_path, "config.json")
    if os.path.isdir(model_path) and os.path.exists(cj):
        try:
            with open(cj) as f:
                return json.load(f).get("scheduler_type", "lms")
        except (OSError, ValueError):
            pass
    return "lms"


def _unet_json(u: UNetConfig, class_name: str) -> dict:
    """A UNet's or a ControlNet's ``config.json``, diffusers' field names."""
    out = {
        "_class_name": class_name,
        "in_channels": u.in_channels, "out_channels": u.out_channels,
        "sample_size": u.sample_size, "block_out_channels": list(u.block_out_channels),
        "layers_per_block": u.layers_per_block,
        "attention_head_dim": [u.heads_for(ch)[0] for ch in u.block_out_channels]
        if u.attention_head_dim is not None else u.num_attention_heads,
        "use_linear_projection": u.attention_head_dim is not None,
        "prediction_type": u.prediction_type,
        "cross_attention_dim": u.cross_attention_dim, "norm_num_groups": u.norm_num_groups,
        "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                             for a in u.down_block_has_attn],
        "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D"
                           for a in u.up_block_has_attn],
    }
    if u.transformer_depth is not None:
        out["transformer_layers_per_block"] = list(u.transformer_depth)
    if u.addition_embed_type is not None:
        out.update(addition_embed_type=u.addition_embed_type,
                   addition_time_embed_dim=u.addition_time_embed_dim,
                   projection_class_embeddings_input_dim=u.projection_class_embeddings_input_dim)
    if u.time_cond_proj_dim is not None:
        out["time_cond_proj_dim"] = u.time_cond_proj_dim
    return out


def _check_format(weights_format: str) -> None:
    if weights_format not in ("safetensors", "bin"):
        raise ValueError(f"weights_format must be 'safetensors' or 'bin', got "
                         f"{weights_format!r}")


def _write_part(d: str, cfg_json: dict, state: Dict[str, torch.Tensor], stem: str,
                bin_name: str, weights_format: str, linear_projection: bool = False) -> None:
    """One module's ``config.json`` and weights file in directory ``d``; with
    ``linear_projection`` the Transformer2D ``proj_in``/``proj_out`` weights
    are stored as Linear ones, as diffusers' ``use_linear_projection`` does."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=1)
    sd = {}
    for key, t in state.items():
        if (linear_projection and t.dim() == 4
                and re.search(r"attentions\.\d+\.proj_(in|out)\.weight$", key)):
            t = t[:, :, 0, 0]
        sd[key] = t.detach()
    if weights_format == "safetensors":  # copies one tensor at a time to the host
        safetensors_io.save_file(sd, os.path.join(d, stem + ".safetensors"))
    else:
        torch.save({k: t.to("cpu").contiguous() for k, t in sd.items()},
                   os.path.join(d, bin_name))


def _clip_json(c: CLIPTextConfig) -> dict:
    """A text tower's ``config.json``, transformers' field names."""
    out = {
        "architectures": ["CLIPTextModel" if c.projection_dim is None
                          else "CLIPTextModelWithProjection"],
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size, "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "max_position_embeddings": c.max_position_embeddings, "hidden_act": c.hidden_act,
        "eos_token_id": c.eos_token_id,
    }
    if c.projection_dim is not None:
        out["projection_dim"] = c.projection_dim
    return out


def save_diffusers_checkpoint(path: str, config: SDModelConfig, params: StateDicts,
                              tokenizer=None, weights_format: str = "safetensors",
                              tokenizer_2=None) -> None:
    """Write ``params`` as a diffusers-layout directory that
    :func:`load_pipeline_checkpoint` (and the JAX package's loader) reads:
    the ``config.json`` files and ``model_index.json`` with diffusers' field
    names, the weights in their own types as ``.safetensors`` or ``.bin``,
    and the tokenizers' files for a real-BPE ``tokenizer`` (and SDXL-base's
    ``tokenizer_2``, default ``tokenizer``). An SD-2.x or SDXL config (a set
    ``attention_head_dim``) stores ``proj_in`` and ``proj_out`` as Linear
    weights, as diffusers' ``use_linear_projection`` does. SDXL-base's
    second tower goes to ``text_encoder_2/``, and so does the refiner's one
    tower, with its tokenizer in ``tokenizer_2/``. Each file is written one
    tensor at a time."""
    from ..tokenizer.clip_bpe import save_tokenizer_assets

    _check_format(weights_format)
    v = config.vae
    vae_json = {
        "_class_name": "AutoencoderKL", "latent_channels": v.latent_channels,
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block, "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor,
    }
    os.makedirs(path, exist_ok=True)
    index = {"_class_name": "StableDiffusionPipeline",
             "unet": ["diffusers", "UNet2DConditionModel"],
             "text_encoder": ["transformers", "CLIPTextModel"],
             "vae": ["diffusers", "AutoencoderKL"]}
    towers = [("clip", "text_encoder", "tokenizer", tokenizer)]
    if config.xl_refiner:
        index = {"_class_name": "StableDiffusionXLImg2ImgPipeline",
                 "unet": index["unet"], "vae": index["vae"],
                 "text_encoder_2": ["transformers", "CLIPTextModelWithProjection"],
                 "requires_aesthetics_score": True}
        towers = [("clip", "text_encoder_2", "tokenizer_2", tokenizer)]
    elif config.is_xl:
        index.update(_class_name="StableDiffusionXLPipeline",
                     text_encoder_2=["transformers", "CLIPTextModelWithProjection"])
        towers.append(("clip2", "text_encoder_2", "tokenizer_2", tokenizer_2 or tokenizer))
    if config.needs_pooled:
        index["force_zeros_for_empty_prompt"] = config.force_zeros_for_empty_prompt
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=1)
    _write_part(os.path.join(path, "unet"), _unet_json(config.unet, "UNet2DConditionModel"),
                params["unet"], "diffusion_pytorch_model", "diffusion_pytorch_model.bin",
                weights_format, linear_projection=config.unet.attention_head_dim is not None)
    for part, subdir, tok_dir, tok in towers:
        _write_part(os.path.join(path, subdir), _clip_json(getattr(config, part)),
                    params[part], "model", "pytorch_model.bin", weights_format)
        if tok is not None:
            save_tokenizer_assets(tok, os.path.join(path, tok_dir))
    _write_part(os.path.join(path, "vae"), vae_json, params["vae"], "diffusion_pytorch_model",
                "diffusion_pytorch_model.bin", weights_format)


def save_controlnet_checkpoint(path: str, config: SDModelConfig, state: Dict[str, torch.Tensor],
                               weights_format: str = "safetensors") -> None:
    """Write a ControlNet state dict for ``config`` as a diffusers
    ``ControlNetModel`` directory that :func:`load_controlnet_checkpoint`
    reads (``config.json`` and the weights in their own types)."""
    _check_format(weights_format)
    cfg_json = _unet_json(config.unet, "ControlNetModel")
    for key in ("out_channels", "sample_size", "prediction_type", "up_block_types"):
        del cfg_json[key]
    cfg_json.update(conditioning_channels=3, conditioning_embedding_out_channels=[16, 32, 96, 256])
    _write_part(path, cfg_json, state, "diffusion_pytorch_model", "diffusion_pytorch_model.bin",
                weights_format, linear_projection=config.unet.attention_head_dim is not None)
