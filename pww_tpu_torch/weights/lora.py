"""LoRA (low-rank adaptation) loading, merging and unloading.

Port of :mod:`pww_tpu.weights.lora`. A LoRA is merged into the weights
before any call, ``W' = W + scale · (alpha / r) · up @ down``, so the
denoise runs the unchanged UNet (its K1-K3 sites included) and the adapter
costs nothing per step.

Checkpoint layouts (``.safetensors`` or torch ``.bin``), as the JAX
package reads them:

- kohya-ss / A1111: ``lora_unet_<module>.lora_down.weight`` /
  ``.lora_up.weight`` / ``.alpha``, with ``lora_te_`` (SD) or
  ``lora_te1_`` / ``lora_te2_`` (SDXL) for the text towers; LoCon entries
  on 3×3 resnet convs and 1×1 transformer ``proj_in``/``proj_out`` convs;
- diffusers / peft: ``unet.<module>.lora_A.weight`` / ``lora_B.weight``,
  legacy ``<module>.lora.down.weight`` / ``.lora.up.weight``, and the
  attention-processor form ``unet.<module>.processor.to_q_lora.down.weight``.

The port's state dicts carry diffusers' and transformers' names, so a
parameter ``down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_q.weight``
is the module ``down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_q``
(kohya text-tower names keep ``text_model_``). Only diffusers' UNet names
match: kohya sd-scripts' SDXL files name UNet modules in the LDM layout
(``lora_unet_input_blocks_4_1_…``), so such a file merges into the text
towers alone and warns for every UNet module, in both packages (ROADMAP
C.15).

The delta is computed in f32 in torch layout, times ``alpha / r``, added to
the f32 upcast of the weight at ``scale`` and cast back to the weight's
type, on the weight's device (``pww_tpu/weights/lora.py:155-221``).
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .loader import read_state_dict

_KOHYA_TOWER = {"lora_unet": "unet", "lora_te": "clip",
                "lora_te1": "clip", "lora_te2": "clip2"}
_DIFFUSERS_TOWER = {"unet": "unet", "text_encoder": "clip",
                    "text_encoder_2": "clip2"}
# attention-processor naming: `processor.to_q_lora.down` → module `to_q`
_PROCESSOR_LORA = {"to_q_lora": "to_q", "to_k_lora": "to_k",
                   "to_v_lora": "to_v", "to_out_lora": "to_out_0"}


def _f32(x) -> torch.Tensor:
    """A checkpoint tensor or numpy array → an f32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


@dataclass
class LoraEntry:
    down: torch.Tensor  # (r, in) or (r, I, kh, kw), f32
    up: torch.Tensor  # (out, r) or (O, r, 1, 1), f32
    alpha: Optional[float] = None

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    @property
    def factor(self) -> float:
        return 1.0 if self.alpha is None else self.alpha / self.rank


@dataclass
class LoraWeights:
    """A parsed LoRA: ``{tower: {flat_module_name: LoraEntry}}``, the tower
    "unet", "clip" or "clip2"."""

    towers: Dict[str, Dict[str, LoraEntry]] = field(default_factory=dict)

    def __len__(self) -> int:
        return sum(len(v) for v in self.towers.values())


def _canon_diffusers_module(mod: str) -> str:
    """A diffusers module path → its kohya-style flat name."""
    parts = mod.split(".")
    if len(parts) >= 2 and parts[-2] == "processor":
        parts = parts[:-2] + [_PROCESSOR_LORA.get(parts[-1], parts[-1])]
    return "_".join(parts)


def parse_lora_state(state: Dict) -> LoraWeights:
    """Group a raw LoRA state dict (tensors or numpy arrays) into per-module
    (down, up, alpha) entries; unrecognised keys and modules missing a half
    warn and are skipped."""
    partial: Dict[Tuple[str, str], dict] = {}
    unrecognized = []
    for key, val in state.items():
        m = re.fullmatch(
            r"(lora_unet|lora_te1|lora_te2|lora_te)_(.+)\.(lora_down\.weight"
            r"|lora_up\.weight|alpha)", key)
        if m:
            which = {"lora_down.weight": "down", "lora_up.weight": "up",
                     "alpha": "alpha"}[m[3]]
            partial.setdefault((_KOHYA_TOWER[m[1]], m[2]), {})[which] = val
            continue
        m = re.fullmatch(
            r"(?:(unet|text_encoder_2|text_encoder)\.)?(.+?)\."
            r"(lora_A\.weight|lora_B\.weight|lora\.down\.weight"
            r"|lora\.up\.weight|down\.weight|up\.weight)", key)
        if m:
            tower = _DIFFUSERS_TOWER[m[1] or "unet"]
            which = "down" if ("down" in m[3] or "lora_A" in m[3]) else "up"
            partial.setdefault((tower, _canon_diffusers_module(m[2])), {})[which] = val
            continue
        unrecognized.append(key)
    if unrecognized:
        warnings.warn(f"lora: {len(unrecognized)} unrecognized keys ignored "
                      f"(first few: {unrecognized[:4]})")
    towers: Dict[str, Dict[str, LoraEntry]] = {}
    for (tower, mod), d in partial.items():
        if "down" not in d or "up" not in d:
            warnings.warn(f"lora: module {tower}/{mod} missing down or up half; skipped")
            continue
        alpha = d.get("alpha")
        towers.setdefault(tower, {})[mod] = LoraEntry(
            down=_f32(d["down"]), up=_f32(d["up"]),
            alpha=None if alpha is None else float(_f32(alpha).double().reshape(-1)[0]))
    return LoraWeights(towers)


def load_lora_file(path: str) -> LoraWeights:
    """Read and parse a LoRA checkpoint file."""
    return parse_lora_state(read_state_dict(path))


def _delta_for(entry: LoraEntry, weight: torch.Tensor) -> torch.Tensor:
    """The dense f32 delta in torch layout for ``weight``, on its device: a
    linear LoRA may land on a 1×1 conv and a conv LoRA on a linear layer."""
    down, up = entry.down.to(weight.device), entry.up.to(weight.device)
    if down.dim() == 4 or up.dim() == 4:  # LoCon: down (r, I, kh, kw), up (O, r, 1, 1)
        r, o = down.shape[0], up.shape[0]
        delta = torch.einsum("or,rihw->oihw", up.reshape(o, r),
                             down.reshape(r, *down.shape[1:]))
        if weight.dim() == 2:
            delta = delta[:, :, 0, 0]
    else:
        delta = up @ down  # (out, in)
        if weight.dim() == 4:
            delta = delta[:, :, None, None]
    if tuple(delta.shape) != tuple(weight.shape):
        raise ValueError(f"lora delta shape {tuple(delta.shape)} does not match target "
                         f"{tuple(weight.shape)} (rank {entry.rank})")
    return delta * np.float32(entry.factor).item()


def _flat_key(key: str, t: torch.Tensor) -> Optional[str]:
    """A state-dict key → its kohya-style flat module name, for the linear
    and conv weights (the JAX trees' ``kernel`` leaves) only."""
    if not key.endswith(".weight") or t.dim() not in (2, 4) or key.endswith("embedding.weight"):
        return None
    return key[: -len(".weight")].replace(".", "_")


def merge_lora_tower(state: Dict[str, torch.Tensor], entries: Dict[str, LoraEntry],
                     scale: float, saved: Optional[dict] = None):
    """Merge one tower's entries into its state dict. Returns ``(new_state,
    n_applied, touched)``: ``touched`` maps each merged key to its tensor
    before the merge, except keys already in ``saved`` (a stacked LoRA
    keeps the first original)."""
    out = dict(state)
    applied, touched = set(), {}
    for key, t in state.items():
        mod = _flat_key(key, t)
        if mod is None or mod not in entries:
            continue
        delta = _delta_for(entries[mod], t)
        if saved is None or key not in saved:
            touched[key] = t
        out[key] = (t.float() + scale * delta).to(t.dtype)
        applied.add(mod)
    missing = set(entries) - applied
    if missing:
        warnings.warn(f"lora: {len(missing)} modules had no matching parameter "
                      f"(first few: {sorted(missing)[:4]})")
    return out, len(applied), touched


def merge_lora(params: Dict[str, Dict[str, torch.Tensor]], lora: LoraWeights,
               scale: float = 1.0, saved: Optional[Dict[str, dict]] = None):
    """Merge a parsed LoRA into ``{"unet", "clip"[, "clip2"]: state dict}``.
    Returns ``(new_params, n_applied, touched)``, ``touched`` the pre-merge
    tensors per tower; a tower the pipeline lacks warns and is skipped."""
    new_params = dict(params)
    total = 0
    all_touched: Dict[str, dict] = {}
    for tower, entries in lora.towers.items():
        if tower not in params:
            if entries:
                warnings.warn(f"lora: checkpoint has {tower} entries but the pipeline has "
                              f"no {tower} params (wrong model family?); skipped")
            continue
        new_params[tower], n, all_touched[tower] = merge_lora_tower(
            params[tower], entries, scale, saved=None if saved is None else saved.get(tower))
        total += n
    return new_params, total, all_touched


def restore_params(params: Dict[str, Dict[str, torch.Tensor]],
                   saved: Dict[str, dict]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Put back the pre-LoRA tensors that :func:`merge_lora` recorded."""
    out = dict(params)
    for tower, touched in saved.items():
        if touched:
            out[tower] = {**out[tower], **touched}
    return out
