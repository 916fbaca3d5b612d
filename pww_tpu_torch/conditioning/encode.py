"""Prompt + color-context encoding → typed PwW conditioning.

Port of the plain case of :func:`pww_tpu.conditioning.encode.
encode_text_color_inputs` (no long prompts, prompt weighting or CLIP skip):
tokenize (with SDXL's second tokenizer too), parse the color context,
rasterize the bias pyramid on the device and CLIP-encode, with CFG batched
as ``[uncond, cond]``. The PwW token match uses the first tokenizer's ids,
as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.weight_functions import AnyWeightFunction, as_weight_function
from ..types import PwwState
from .color_context import Region, separate_image_context, token_match_matrix
from .rasterize import rasterize_pyramid


@dataclasses.dataclass
class EncodedInputs:
    """Everything the denoise loop needs, CFG-batched (row 0 = uncond)."""

    text_states: torch.Tensor  # (2, T, D): [uncond, cond]
    pww: PwwState  # weights have batch dim 2 with zero uncond rows
    regions: List[Region]
    width: int
    height: int
    pooled: Optional[torch.Tensor] = None  # (2, D_pool): SDXL's pooled text


def _padded_ids(tokenizer, text: str) -> List[int]:
    max_len = tokenizer.model_max_length
    ids = tokenizer(
        text, max_length=max_len, truncation=True, padding="max_length",
    )["input_ids"]
    if len(ids) < max_len:
        pad = getattr(tokenizer, "pad_token_id", tokenizer.eos_token_id)
        ids = list(ids) + [pad] * (max_len - len(ids))
    return list(ids)


def encode_text_color_inputs(
    encode_text: Callable[[torch.Tensor], torch.Tensor],
    tokenizer,
    color_map: Optional[np.ndarray],  # (H, W, 3) uint8 or None
    color_context: Dict,
    prompt: str,
    negative_prompt: str = "",
    weight_function: Optional[AnyWeightFunction] = None,
    device="cpu",
    tokenizer_2=None,
    zero_empty_negative: bool = False,
) -> EncodedInputs:
    """Host prologue + device rasterization + CLIP encode.

    ``encode_text`` maps (B, 77) int64 ids on ``device`` to (B, 77, D)
    hidden states, or to ``(text_states, pooled)`` for SDXL; with
    ``tokenizer_2`` it takes the second tokenizer's ids as well.
    ``zero_empty_negative`` (SDXL's ``force_zeros_for_empty_prompt``): an
    empty negative prompt gives all-zero uncond text states and pooled
    vector (``pww_tpu/conditioning/encode.py:262-267``).
    """
    prompt_ids = _padded_ids(tokenizer, prompt)
    uncond_ids = _padded_ids(tokenizer, negative_prompt)
    n_text = tokenizer.model_max_length

    regions, width, height = separate_image_context(
        color_map, dict(color_context), tokenizer
    )
    match = token_match_matrix(regions, prompt_ids, n_text)
    masks = np.stack([r.mask for r in regions])  # (R, H, W)
    blur = [r.blur_sigma if r.blur_sigma else 0.0 for r in regions]
    pyramid, orig = rasterize_pyramid(
        torch.from_numpy(masks).to(device),
        torch.from_numpy(match).to(device),
        blur if any(s > 0 for s in blur) else None,
        height=height,
        width=width,
    )

    # CFG batch: row 0 uncond (zero weights — the reference passes int 0).
    def cfg_pair(x: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.zeros_like(x), x])

    ids = torch.tensor([uncond_ids, prompt_ids], dtype=torch.int64, device=device)
    if tokenizer_2 is None:
        out = encode_text(ids)
    else:
        ids2 = torch.tensor([_padded_ids(tokenizer_2, negative_prompt),
                             _padded_ids(tokenizer_2, prompt)], dtype=torch.int64, device=device)
        out = encode_text(ids, ids2)
    text_states, pooled = out if isinstance(out, tuple) else (out, None)
    if zero_empty_negative and negative_prompt == "" and pooled is not None:
        text_states, pooled = text_states.clone(), pooled.clone()
        text_states[0] = 0.0
        pooled[0] = 0.0
    pww = PwwState(
        weights={k: cfg_pair(v) for k, v in pyramid.items()},
        weight_orig=cfg_pair(orig),
        sigma=torch.zeros((), dtype=torch.float32, device=device),
        weight_fn=as_weight_function(weight_function),
    )
    return EncodedInputs(
        text_states=text_states,
        pww=pww,
        regions=regions,
        width=width,
        height=height,
        pooled=pooled,
    )
