"""A1111/LDM single-file checkpoints → the port's state dicts.

Port of :mod:`pww_tpu.weights.ldm_convert` (the reference's vendored
converter, ``change_model_path.py:51-943``): the LDM → diffusers renaming
tables for ``model.diffusion_model.*`` and ``first_stage_model.*``, the
text tower under ``cond_stage_model.transformer.*`` (HF CLIP, SD-1.x) or
``cond_stage_model.model.*`` (OpenCLIP, SD-2.x, its fused ``in_proj``
split into q, k and v), EMA extraction, the family detection and the CLI.
The port's modules carry diffusers' names, so the renamed dicts go straight
to :func:`~.loader.convert_state_dict`, which also turns the old VAE
attention names into the new ones. An original-LDM checkpoint's LDM-BERT
tower converts with :func:`convert_ldm_bert`; the paint-with-words pipeline
refuses it, as the reference does.

    python -m pww_tpu_torch.weights.ldm_convert --checkpoint_path model.safetensors \\
        --dump_path out_dir [--extract_ema] [--prediction_type auto] [--tokenizer_dir DIR]

writes the diffusers layout (:func:`~.loader.save_diffusers_checkpoint`)
with a top-level ``config.json`` recording the scheduler;
``--text_encoder_only`` writes an LDM-BERT tower as ``ldm_bert.safetensors``
and ``config.json`` with ``{"ldm_bert": ...}``.
"""
from __future__ import annotations

import dataclasses
import os
import re
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..config import LDMBertConfig, SDModelConfig, UNetConfig
from .bridge import build_models
from .loader import convert_state_dict, read_state_dict

State = Dict[str, torch.Tensor]

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer."
OPEN_CLIP_PREFIX = "cond_stage_model.model."

# resnet internals, LDM → diffusers
_UNET_RES = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_VAE_RES = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
            "nin_shortcut": "conv_shortcut"}
# the old diffusers names; loader.convert_state_dict renames them
_VAE_ATTN = {"norm": "group_norm", "q": "query", "k": "key", "v": "value",
             "proj_out": "proj_attn"}


def _rename(rest: str, table: Dict[str, str]) -> str:
    for src, dst in table.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    return rest


def _map_unet_key(key: str, layers_per_block: int = 2) -> Optional[str]:
    """``model.diffusion_model.X`` (prefix stripped) → the diffusers UNet key,
    or None to skip (``pww_tpu/weights/ldm_convert.py:61-115``)."""
    for src, dst in (("time_embed.0.", "time_embedding.linear_1."),
                     ("time_embed.2.", "time_embedding.linear_2."),
                     ("input_blocks.0.0.", "conv_in."), ("out.0.", "conv_norm_out."),
                     ("out.2.", "conv_out.")):
        if key.startswith(src):
            return dst + key[len(src):]
    per = layers_per_block + 1
    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.+)", key)
    if m:
        i, sub, rest = int(m[1]), int(m[2]), m[3]
        block, layer = (i - 1) // per, (i - 1) % per
        if layer == layers_per_block:  # the downsample slot
            assert rest.startswith("op."), key
            return f"down_blocks.{block}.downsamplers.0.conv.{rest[3:]}"
        if sub == 0:
            return f"down_blocks.{block}.resnets.{layer}.{_rename(rest, _UNET_RES)}"
        return f"down_blocks.{block}.attentions.{layer}.{rest}"
    m = re.match(r"middle_block\.(\d+)\.(.+)", key)
    if m:
        sub, rest = int(m[1]), m[2]
        if sub in (0, 2):
            return f"mid_block.resnets.{sub // 2}.{_rename(rest, _UNET_RES)}"
        return f"mid_block.attentions.0.{rest}"
    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.+)", key)
    if m:
        i, sub, rest = int(m[1]), int(m[2]), m[3]
        block, layer = i // per, i % per
        if rest.startswith("conv.") and sub >= 1 and layer == layers_per_block:
            # the upsampler: the block's last module (index 1 without attention, 2 with)
            return f"up_blocks.{block}.upsamplers.0.{rest}"
        if sub == 0:
            return f"up_blocks.{block}.resnets.{layer}.{_rename(rest, _UNET_RES)}"
        return f"up_blocks.{block}.attentions.{layer}.{rest}"
    return None


def _map_vae_key(key: str, num_blocks: int = 4) -> Optional[str]:
    """``first_stage_model.X`` (prefix stripped) → the diffusers VAE key, or
    None; the LDM decoder's ``up.i`` runs outermost last, diffusers'
    ``up_blocks`` the other way (``pww_tpu/weights/ldm_convert.py:118-166``)."""
    if key.startswith(("quant_conv.", "post_quant_conv.")):
        return key
    for side in ("encoder", "decoder"):
        if not key.startswith(side + "."):
            continue
        k = key[len(side) + 1:]
        if k.startswith(("conv_in.", "conv_out.")):
            return f"{side}.{k}"
        if k.startswith("norm_out."):
            return f"{side}.conv_norm_out.{k[len('norm_out.'):]}"
        m = re.match(r"(down|up)\.(\d+)\.block\.(\d+)\.(.+)", k)
        if m:
            i = int(m[2])
            if side == "decoder":
                i = num_blocks - 1 - i
            return f"{side}.{m[1]}_blocks.{i}.resnets.{m[3]}.{_rename(m[4], _VAE_RES)}"
        m = re.match(r"down\.(\d+)\.downsample\.conv\.(.+)", k)
        if m:
            return f"{side}.down_blocks.{m[1]}.downsamplers.0.conv.{m[2]}"
        m = re.match(r"up\.(\d+)\.upsample\.conv\.(.+)", k)
        if m:
            return f"{side}.up_blocks.{num_blocks - 1 - int(m[1])}.upsamplers.0.conv.{m[2]}"
        m = re.match(r"mid\.block_(\d)\.(.+)", k)
        if m:
            return f"{side}.mid_block.resnets.{int(m[1]) - 1}.{_rename(m[2], _VAE_RES)}"
        m = re.match(r"mid\.attn_1\.(.+)", k)
        if m:
            return f"{side}.mid_block.attentions.0.{_rename(m[1], _VAE_ATTN)}"
    return None


def _convert_open_clip(raw: State) -> State:
    """The OpenCLIP text tower (``cond_stage_model.model.*`` stripped, SD-2.x)
    → transformers' ``text_model.*`` keys; the fused ``attn.in_proj_*``
    splits into q, k and v (``pww_tpu/weights/ldm_convert.py:169-214``)."""
    out: State = {}
    layer_parts = (("attn.out_proj.", "self_attn.out_proj."), ("ln_1.", "layer_norm1."),
                   ("ln_2.", "layer_norm2."), ("mlp.c_fc.", "mlp.fc1."),
                   ("mlp.c_proj.", "mlp.fc2."))
    for k, v in raw.items():
        if k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = v
        elif k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = v
        elif k.startswith("ln_final."):
            out["text_model.final_layer_norm." + k[len("ln_final."):]] = v
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", k)
        if not m:
            continue
        base, rest = f"text_model.encoder.layers.{m[1]}.", m[2]
        if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
            leaf = "weight" if rest.endswith("weight") else "bias"
            for name, part in zip(("q_proj", "k_proj", "v_proj"), torch.chunk(v, 3, dim=0)):
                out[f"{base}self_attn.{name}.{leaf}"] = part
            continue
        for src, dst in layer_parts:
            if rest.startswith(src):
                out[base + dst + rest[len(src):]] = v
    return out


# -- LDM-BERT ---------------------------------------------------------------
# x-transformers interleaves [norm, attention] and [norm, feed-forward] in one
# list: layer i reads slots 2i and 2i + 1 (the reference's stride-2 walk,
# change_model_path.py:771-774); q/k/v have no bias.

def is_ldm_bert_sd(text_sd: State) -> bool:
    """True for an original-LDM BERT tower (``cond_stage_model.transformer.``
    stripped): it starts at ``token_emb``, a CLIP one at ``text_model.``."""
    return "token_emb.weight" in text_sd


def ldm_bert_key(key: str) -> str:
    """:class:`~..models.ldm_bert.LDMBertModel` state-dict key → its LDM
    checkpoint key (``pww_tpu/weights/ldm_convert.py:232-260``)."""
    fixed = {"embed_tokens.weight": "token_emb.weight",
             "embed_positions.weight": "pos_emb.emb.weight"}
    if key in fixed:
        return fixed[key]
    if key.startswith("layer_norm."):
        return "norm." + key[len("layer_norm."):]
    if key.startswith("to_logits."):
        return key
    m = re.fullmatch(r"layers\.(\d+)\.(\w+)\.(?:(\w+)\.)?(weight|bias)", key)
    assert m, key
    i, sub, proj, leaf = int(m[1]), m[2], m[3], m[4]
    if sub == "self_attn_layer_norm":
        return f"attn_layers.layers.{2 * i}.0.{leaf}"
    if sub == "self_attn":
        to = {"q_proj": "to_q", "k_proj": "to_k", "v_proj": "to_v", "out_proj": "to_out"}[proj]
        return f"attn_layers.layers.{2 * i}.1.{to}.{leaf}"
    if sub == "final_layer_norm":
        return f"attn_layers.layers.{2 * i + 1}.0.{leaf}"
    inner = {"fc1": "net.0.0", "fc2": "net.2"}[sub]
    return f"attn_layers.layers.{2 * i + 1}.1.{inner}.{leaf}"


def convert_ldm_bert(text_sd: State, num_heads: Optional[int] = None,
                     head_dim: Optional[int] = None) -> Tuple[LDMBertConfig, State]:
    """An original-LDM BERT state dict → (:class:`LDMBertConfig`, the port's
    state dict). The sizes come from the tensors' shapes; the head split,
    which no shape fixes, defaults to heads of 64 where the attention width
    divides by 64, else 8 heads (diffusers' defaults,
    ``pww_tpu/weights/ldm_convert.py:263-306``)."""
    from ..models.ldm_bert import LDMBertModel

    vocab, d_model = (int(s) for s in text_sd["token_emb.weight"].shape)
    max_pos = int(text_sd["pos_emb.emb.weight"].shape[0])
    inner = int(text_sd["attn_layers.layers.0.1.to_q.weight"].shape[0])
    ffn = int(text_sd["attn_layers.layers.1.1.net.0.0.weight"].shape[0])
    slots = [int(m[1]) for k in text_sd if (m := re.match(r"attn_layers\.layers\.(\d+)\.", k))]
    if head_dim is None and num_heads is None:
        head_dim = 64 if inner % 64 == 0 else inner // 8
    if num_heads is None:
        num_heads = inner // head_dim
    elif head_dim is None:
        head_dim = inner // num_heads
    if num_heads * head_dim != inner:
        raise ValueError(f"num_heads ({num_heads}) × head_dim ({head_dim}) != attention "
                         f"inner dim {inner} inferred from to_q.weight")
    config = LDMBertConfig(vocab_size=vocab, d_model=d_model, num_layers=(max(slots) + 1) // 2,
                           num_heads=num_heads, head_dim=head_dim, ffn_dim=ffn,
                           max_position_embeddings=max_pos)
    with torch.device("meta"):
        expected = LDMBertModel(config).state_dict()
    state, missing = {}, []
    for key, ref in expected.items():
        src = text_sd.get(ldm_bert_key(key))
        if src is None:
            missing.append(key)
        elif tuple(src.shape) != tuple(ref.shape):
            raise ValueError(f"ldm_bert: shape mismatch at {key}: checkpoint "
                             f"{tuple(src.shape)} vs model {tuple(ref.shape)}")
        else:
            state[key] = torch.as_tensor(src)
    if missing:
        raise KeyError(f"ldm_bert: {len(missing)} params missing from checkpoint: "
                       + "; ".join(missing[:8]))
    return config, state


# -- SD checkpoints -----------------------------------------------------------

def convert_ldm_state_dict(state: State, extract_ema: bool = False,
                           layers_per_block: int = 2,
                           vae_blocks: int = 4) -> Tuple[State, State, State]:
    """Split and rename an LDM state dict into diffusers-keyed (unet, vae,
    text tower) dicts. ``extract_ema`` takes the ``model_ema.*`` shadows,
    whose names squash out the dots, for the UNet weights they match
    (``model_ema.decay`` and ``model_ema.num_updates`` match none). The VAE
    attention's 1×1 convs become Linear weights. The JAX converter's tables
    assume SD's 2 layers a UNet block and 4 VAE blocks, the defaults here."""
    if extract_ema:
        ema = {k[len("model_ema."):].replace(".", ""): k for k in state
               if k.startswith("model_ema.")}
        shadows = {}
        for k in state:
            if k.startswith(UNET_PREFIX):
                flat = k[len("model."):].replace(".", "")
                if flat in ema:
                    shadows[k] = state[ema[flat]]
        state = {**state, **shadows}
    unet, vae, clip, open_clip = {}, {}, {}, {}
    for k, v in state.items():
        if k.startswith(UNET_PREFIX):
            nk = _map_unet_key(k[len(UNET_PREFIX):], layers_per_block)
            if nk:
                unet[nk] = v
        elif k.startswith(VAE_PREFIX):
            nk = _map_vae_key(k[len(VAE_PREFIX):], vae_blocks)
            if nk:
                if v.dim() == 4 and any(s in nk for s in (".query.", ".key.", ".value.",
                                                          ".proj_attn.")):
                    v = v[:, :, 0, 0]
                vae[nk] = v
        elif k.startswith(CLIP_PREFIX):
            clip[k[len(CLIP_PREFIX):]] = v
        elif k.startswith(OPEN_CLIP_PREFIX):
            open_clip[k[len(OPEN_CLIP_PREFIX):]] = v
    if open_clip and not clip:
        clip = _convert_open_clip(open_clip)
    return unet, vae, clip


def detect_ldm_config(ckpt_meta: Dict, unet_sd: State,
                      prediction_type: str = "auto") -> SDModelConfig:
    """The model family from the UNet's shapes
    (``pww_tpu/weights/ldm_convert.py:353-420``): cross-attention context
    768 → SD-1.x, 1024 → SD-2.x, which is ε-prediction (SD-2.1-base) at
    ``global_step`` 220000 and v-prediction (the 768-v family) otherwise,
    with a warning unless the step is 110000 (SD-2.1-768). ``ckpt_meta``
    holds the header fields outside the state dict
    (``read_state_dict(..., return_meta=True)``); ``prediction_type``
    ("epsilon" or "v_prediction") overrides; ``in_channels`` follows
    ``conv_in``."""
    in_channels = int(unet_sd["conv_in.weight"].shape[1])
    ctx_dim = next((int(v.shape[1]) for k, v in unet_sd.items()
                    if k.endswith("attn2.to_k.weight")), None)
    if ctx_dim == 1024:
        if prediction_type == "auto":
            step = ckpt_meta.get("global_step")
            step = int(step) if step is not None else None
            v_pred = step != 220000
            if v_pred and step != 110000:
                warnings.warn(
                    f"SD-2.x checkpoint with no recognized global_step ({step}): assuming "
                    "v_prediction (the SD-2.1-768 family). Pass prediction_type='epsilon' "
                    "for 512-base models.")
        else:
            v_pred = prediction_type == "v_prediction"
        config = SDModelConfig.sd21(v_prediction=v_pred)
        if in_channels != config.unet.in_channels:
            config = dataclasses.replace(
                config, unet=dataclasses.replace(config.unet, in_channels=in_channels))
        return config
    config = SDModelConfig(unet=UNetConfig.sd15(in_channels=in_channels))
    if prediction_type not in ("auto", config.unet.prediction_type):
        config = dataclasses.replace(
            config, unet=dataclasses.replace(config.unet, prediction_type=prediction_type))
    return config


def _find_tokenizer(path: str, tokenizer_path: Optional[str]):
    """Real BPE files for a single-file checkpoint: ``tokenizer_path`` (a
    directory with ``vocab.json`` and ``merges.txt``, or openai/CLIP's
    ``bpe_simple_vocab_16e6.txt.gz``), else either beside the checkpoint;
    None, with a loud warning, when there are none (the caller falls back to
    the toy tokenizer, whose ids match no real CLIP vocabulary)."""
    from ..tokenizer.clip_bpe import CLIPTokenizer

    ckpt_dir = os.path.dirname(os.path.abspath(path))
    candidates = ([tokenizer_path] if tokenizer_path else []) + [
        ckpt_dir, os.path.join(ckpt_dir, "bpe_simple_vocab_16e6.txt.gz")]
    for c in candidates:
        try:
            if c.endswith(".gz") and os.path.exists(c):
                return CLIPTokenizer.from_bpe_gz(c)
            if os.path.isdir(c):
                return CLIPTokenizer.from_dir(c)
        except FileNotFoundError:
            continue
    if tokenizer_path:
        raise FileNotFoundError(f"no tokenizer assets (vocab.json+merges.txt or *.txt.gz) "
                                f"found at {tokenizer_path!r}")
    warnings.warn(
        "single-file checkpoint carries no tokenizer assets and none were found next to "
        "it: falling back to the hash-based toy tokenizer. Region labels will NOT match "
        "real CLIP ids — pass tokenizer_path= (a dir with vocab.json+merges.txt, or "
        "bpe_simple_vocab_16e6.txt.gz).", stacklevel=3)
    return None


def load_ldm_checkpoint(path: str, extract_ema: bool = False, prediction_type: str = "auto",
                        tokenizer_path: Optional[str] = None,
                        config: Optional[SDModelConfig] = None):
    """A single ``.ckpt``/``.safetensors`` file → (config, {"unet", "vae",
    "clip"} state dicts, tokenizer) (``pww_tpu/weights/ldm_convert.py:
    465-525``). ``config`` replaces :func:`detect_ldm_config`, for a model
    of other depths (its layers a block and VAE blocks drive the renaming).
    Tensors keep their stored types; keys the modules do not have (the
    OpenCLIP tower's last layer, which SD-2 skips, its projection) are
    dropped. An original-LDM (LDM-BERT) checkpoint raises ``ValueError``."""
    from ..tokenizer.clip_bpe import toy_tokenizer

    state, ckpt_meta = read_state_dict(path, return_meta=True)
    if config is None:
        unet_sd, vae_sd, clip_sd = convert_ldm_state_dict(state, extract_ema)
    else:
        unet_sd, vae_sd, clip_sd = convert_ldm_state_dict(
            state, extract_ema, config.unet.layers_per_block,
            len(config.vae.block_out_channels))
    if is_ldm_bert_sd(clip_sd):
        # the reference routes LDM-BERT only into the plain LDM pipeline
        # (change_model_path.py:926-937); pww_load_tools always loads CLIP
        raise ValueError(
            f"{path} is an original latent-diffusion checkpoint (LDM-BERT text encoder, "
            "not CLIP). Its text tower converts with pww_tpu_torch.weights.ldm_convert."
            "convert_ldm_bert(clip_sd), but the PwW pipeline requires a CLIP-conditioned SD "
            "checkpoint — same scope as the reference (change_model_path.py:926-937 routes "
            "LDM-BERT only into the plain LDM pipeline, never into PwW).")
    if config is None:
        config = detect_ldm_config(ckpt_meta, unet_sd, prediction_type)
    params = {}
    for part, sd in (("unet", unet_sd), ("vae", vae_sd), ("clip", clip_sd)):
        expected = build_models(config, parts=(part,))[part].state_dict()
        converted = convert_state_dict(part, sd, expected)
        params[part] = {k: v for k, v in converted.items() if k in expected}
    tokenizer = _find_tokenizer(path, tokenizer_path)
    if tokenizer is None:
        tokenizer = toy_tokenizer(config.clip.vocab_size)
    return config, params, tokenizer


# -- CLI (the reference converter's interface, change_model_path.py:812-943) --

def main(argv=None) -> int:
    import argparse
    import json

    from . import safetensors_io
    from .loader import save_diffusers_checkpoint

    ap = argparse.ArgumentParser(
        description="Convert an LDM/A1111 .ckpt or .safetensors checkpoint to a diffusers-"
                    "layout directory that pww_tpu_torch (and pww_tpu) load.")
    ap.add_argument("--checkpoint_path", required=True)
    ap.add_argument("--dump_path", required=True, help="output directory")
    ap.add_argument("--extract_ema", action="store_true")
    ap.add_argument("--prediction_type", default="auto",
                    choices=["auto", "epsilon", "v_prediction"],
                    help="auto: derive from shapes + global_step (SD-2.x 768-v vs "
                         "512-base); override for exotic checkpoints")
    ap.add_argument("--tokenizer_dir", default=None,
                    help="dir with vocab.json+merges.txt (or a bpe_simple_vocab_16e6.txt.gz "
                         "file) to bundle real tokenizer assets")
    ap.add_argument("--scheduler_type", default="lms",
                    choices=["lms", "euler", "euler_ancestral", "ddim", "pndm", "dpmpp_2m",
                             "heun", "unipc"],
                    help="recorded as the default scheduler for the converted model")
    ap.add_argument("--text_encoder_only", action="store_true",
                    help="convert and dump ONLY the text tower of an original-LDM "
                         "(BERT-conditioned) checkpoint, which has no PwW-runnable UNet/VAE")
    args = ap.parse_args(argv)
    os.makedirs(args.dump_path, exist_ok=True)
    source = os.path.basename(args.checkpoint_path)
    if args.text_encoder_only:
        _, _, text_sd = convert_ldm_state_dict(read_state_dict(args.checkpoint_path),
                                               args.extract_ema)
        if not is_ldm_bert_sd(text_sd):
            ap.error("--text_encoder_only is for original-LDM (BERT-conditioned) "
                     "checkpoints; this one has a CLIP tower — run the standard "
                     "conversion instead.")
        config, state = convert_ldm_bert(text_sd)
        safetensors_io.save_file(state, os.path.join(args.dump_path, "ldm_bert.safetensors"))
        with open(os.path.join(args.dump_path, "config.json"), "w") as f:
            json.dump({"ldm_bert": dataclasses.asdict(config), "source": source}, f, indent=2)
        print(f"wrote {args.dump_path}/ldm_bert.safetensors + config.json "
              "(LDM-BERT text tower only)")
        return 0
    config, params, tokenizer = load_ldm_checkpoint(
        args.checkpoint_path, extract_ema=args.extract_ema,
        prediction_type=args.prediction_type, tokenizer_path=args.tokenizer_dir)
    save_diffusers_checkpoint(args.dump_path, config, params, tokenizer)
    with open(os.path.join(args.dump_path, "config.json"), "w") as f:
        json.dump({"scheduler_type": args.scheduler_type, "source": source,
                   "extract_ema": args.extract_ema}, f, indent=2)
    print(f"wrote {args.dump_path} (diffusers layout + config.json)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
