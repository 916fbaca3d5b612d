"""Prompt + color-context encoding → typed PwW conditioning.

Port of :func:`pww_tpu.conditioning.encode.encode_text_color_inputs`:
tokenize (with SDXL's second tokenizer too), parse the color context,
rasterize the bias pyramid on the device and CLIP-encode, with CFG batched
as ``[uncond, cond]``. The PwW token match uses the first tokenizer's ids,
as the reference does. Options: A1111 prompt weighting (per-token
multipliers on the encoder's output, per tower for SDXL), long prompts
(n windows of 77 tokens encoded in one CLIP batch and concatenated along
the sequence: n·77 text keys), CLIP skip, and a text cache of the encoder's
output keyed by (prompt, negative, options).
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
    prompt_ids: Optional[List[int]] = None  # the ids the PwW token match read


def padded_ids(tokenizer, text: str) -> List[int]:
    """``text``'s ids, truncated and padded to the model length."""
    max_len = tokenizer.model_max_length
    ids = tokenizer(
        text, max_length=max_len, truncation=True, padding="max_length",
    )["input_ids"]
    if len(ids) < max_len:
        pad = getattr(tokenizer, "pad_token_id", tokenizer.eos_token_id)
        ids = list(ids) + [pad] * (max_len - len(ids))
    return list(ids)


def _window_ids(tokenizer, text: str, max_len: int) -> List[List[int]]:
    """A1111-style long-prompt windows: the untruncated token stream split
    into ``max_len - 2``-token chunks, each wrapped in BOS/EOS and padded,
    so that every window is a valid CLIP input."""
    raw = tokenizer(text, truncation=False)["input_ids"]
    bos, eos = raw[0], raw[-1]
    inner = raw[1:-1]
    cap = max_len - 2
    n_win = max(1, -(-len(inner) // cap))
    pad = getattr(tokenizer, "pad_token_id", eos)
    wins = []
    for w in range(n_win):
        ids = [bos] + inner[w * cap : (w + 1) * cap] + [eos]
        wins.append(ids + [pad] * (max_len - len(ids)))
    return wins


def _padded_windows(tokenizer, negative_prompt: str, prompt: str, n_win: Optional[int] = None):
    """(uncond windows, cond windows), both padded with empty-prompt windows
    to ``n_win`` (default: the longer of the two)."""
    ml = tokenizer.model_max_length
    u, c = _window_ids(tokenizer, negative_prompt, ml), _window_ids(tokenizer, prompt, ml)
    n = max(len(u), len(c)) if n_win is None else n_win
    empty = _window_ids(tokenizer, "", ml)[0]
    return u + [empty] * (n - len(u)), c + [empty] * (n - len(c))


def _apply_prompt_weights(text_states: torch.Tensor, tok_w: Dict,
                          dual_split_dim: Optional[int]) -> torch.Tensor:
    """Scale the [uncond, cond] hidden states by their per-token
    multipliers, per tower for SDXL's concatenated states (split at
    ``dual_split_dim``); all-ones vectors leave a row untouched."""
    from .prompt_weighting import apply_token_weights

    def scale_row(row, w):
        return row if w is None or (w == 1.0).all() else apply_token_weights(row, w)

    if dual_split_dim is None:
        return torch.stack([scale_row(text_states[0], tok_w.get("1u")),
                            scale_row(text_states[1], tok_w.get("1c"))])
    d = dual_split_dim
    return torch.stack([
        torch.cat([scale_row(text_states[half, :, :d], tok_w.get(f"1{i}")),
                   scale_row(text_states[half, :, d:], tok_w.get(f"2{i}"))], dim=-1)
        for i, half in (("u", 0), ("c", 1))])


def cache_text(text_cache: Optional[Dict], key, value) -> None:
    """Insert into the text cache, dropping its oldest entry past 256."""
    if text_cache is None:
        return
    if len(text_cache) > 256:
        text_cache.pop(next(iter(text_cache)))
    text_cache[key] = value


def encode_text_color_inputs(
    encode_text: Callable[..., torch.Tensor],
    tokenizer,
    color_map: Optional[np.ndarray],  # (H, W, 3) uint8 or None
    color_context: Dict,
    prompt: str,
    negative_prompt: str = "",
    weight_function: Optional[AnyWeightFunction] = None,
    device="cpu",
    tokenizer_2=None,
    zero_empty_negative: bool = False,
    text_cache: Optional[Dict] = None,
    prompt_weighting: bool = False,  # A1111 (word:1.2) emphasis syntax
    clip_skip: int = 0,  # text states k layers early (A1111 CLIP skip k + 1)
    long_prompts: bool = False,  # >77-token windowed prompts (A1111)
    dual_split_dim: Optional[int] = None,  # SDXL: tower 1's width in the states
) -> EncodedInputs:
    """Host prologue + device rasterization + CLIP encode.

    ``encode_text(ids, [ids2], clip_skip=k)`` maps (B, 77) int64 ids on
    ``device`` to (B, 77, D) hidden states, or to ``(text_states, pooled)``
    for SDXL; with ``tokenizer_2`` it takes the second tokenizer's ids as
    well. ``zero_empty_negative`` (SDXL's ``force_zeros_for_empty_prompt``):
    an empty negative prompt gives all-zero uncond text states and pooled
    vector (``pww_tpu/conditioning/encode.py:262-267``). ``text_cache``: a
    dict of the encoder's output by (prompt, negative, options).
    """
    max_len = tokenizer.model_max_length
    tok_w = {}  # per-(tokenizer, row) weight vectors, keyed "1"/"2" + "u"/"c"
    if long_prompts:
        if prompt_weighting:
            raise ValueError("long_prompts and prompt_weighting cannot be combined")
        uncond_wins, cond_wins = _padded_windows(tokenizer, negative_prompt, prompt)
        n_win = len(cond_wins)
        prompt_ids = [t for w in cond_wins for t in w]
        n_text = n_win * max_len
    elif prompt_weighting:
        from .prompt_weighting import weighted_prompt_ids

        prompt_ids, tok_w["1c"] = weighted_prompt_ids(tokenizer, prompt)
        uncond_ids, tok_w["1u"] = weighted_prompt_ids(tokenizer, negative_prompt)
        n_text = max_len
    else:
        prompt_ids = padded_ids(tokenizer, prompt)
        uncond_ids = padded_ids(tokenizer, negative_prompt)
        n_text = max_len

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

    def ids_tensor(rows):
        return torch.tensor(rows, dtype=torch.int64, device=device)

    skip = {"clip_skip": clip_skip} if clip_skip else {}
    cache_key = (prompt, negative_prompt, prompt_weighting, clip_skip, long_prompts)
    if text_cache is not None and cache_key in text_cache:
        text_states, pooled = text_cache[cache_key]
    else:
        if long_prompts:  # one CLIP batch, rows [u_0..u_{n-1}, c_0..c_{n-1}]
            ids = ids_tensor(uncond_wins + cond_wins)
            if tokenizer_2 is None:
                out = encode_text(ids, **skip)
            else:
                u2, c2 = _padded_windows(tokenizer_2, negative_prompt, prompt, n_win)
                if len(u2) != n_win or len(c2) != n_win:
                    raise ValueError("tokenizer_2 produced more windows than tokenizer; "
                                     "prompt too long for matched dual-tower windowing")
                out = encode_text(ids, ids_tensor(u2 + c2), **skip)
        else:
            ids = ids_tensor([uncond_ids, prompt_ids])
            if tokenizer_2 is None:
                out = encode_text(ids, **skip)
            else:
                if prompt_weighting:
                    from .prompt_weighting import weighted_prompt_ids

                    c2, tok_w["2c"] = weighted_prompt_ids(tokenizer_2, prompt)
                    u2, tok_w["2u"] = weighted_prompt_ids(tokenizer_2, negative_prompt)
                else:
                    u2 = padded_ids(tokenizer_2, negative_prompt)
                    c2 = padded_ids(tokenizer_2, prompt)
                out = encode_text(ids, ids_tensor([u2, c2]), **skip)
        text_states, pooled = out if isinstance(out, tuple) else (out, None)
        if long_prompts:  # the windows side by side; the pooled vector of the first
            text_states = text_states.reshape(2, n_win * text_states.shape[1], -1)
            if pooled is not None:
                pooled = torch.stack([pooled[0], pooled[n_win]])
        elif prompt_weighting:
            text_states = _apply_prompt_weights(text_states, tok_w, dual_split_dim)
        if zero_empty_negative and negative_prompt == "" and pooled is not None:
            text_states, pooled = text_states.clone(), pooled.clone()
            text_states[0] = 0.0
            pooled[0] = 0.0
        cache_text(text_cache, cache_key, (text_states, pooled))
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
        prompt_ids=list(prompt_ids),
    )
