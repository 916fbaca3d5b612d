"""Host-side color-context parsing and region-mask extraction.

Port of :mod:`pww_tpu.conditioning.color_context` (a copy: the JAX package
cannot be imported without JAX). String and token work stays on the host;
everything tensor-shaped moves to :mod:`.rasterize`.

Parity with the reference:
  * context format ``"label,strength[,seed[,sigma]]"`` — seed/sigma are split
    first (reference `paint_with_words/paint_with_words.py:279-297`), strength
    last (reference ``:218-221``). The A1111 ControlNet+PwW extension's
    ``"label@strength@seed"`` form (reference `README.md:403-405`) is also
    accepted (:func:`parse_context_entry`).
  * color keys: ``(r, g, b)`` tuples or ``"#RRGGBB"`` hex
    (reference ``:228-230``).
  * exact color match ``(img == color).all(-1)`` scaled by strength
    (reference ``:231-236``), warning when a color is absent (``:233-234``).
  * empty context → single zero mask with sentinel token ``[-1]``
    (reference ``:242-243``).
  * token matching: *all* substring occurrences of the label's token ids in
    the prompt's padded token list (reference ``:259-268``), warning when a
    label never matches (``:270-271``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

ColorKey = Union[str, Tuple[int, int, int]]


def always_round(x: float) -> int:
    """Round-half-to-odd-neighbour quirk preserved from the reference
    (`paint_with_words/paint_with_words.py:18-26`): for even ``int(x)`` round
    half *down*, else banker's ``round``.
    """
    intx = int(x)
    if intx % 2 == 0:
        return intx if x < intx + 0.5 else intx + 1
    return round(x)


@dataclasses.dataclass
class Region:
    """One parsed color-context entry."""

    color: Tuple[int, int, int]
    label: str
    strength: float
    token_ids: List[int]
    mask: np.ndarray  # (H, W) float32, already scaled by strength
    seed: Optional[int] = None
    blur_sigma: Optional[float] = None


def parse_color(color: ColorKey) -> Tuple[int, int, int]:
    if isinstance(color, str):
        return (int(color[1:3], 16), int(color[3:5], 16), int(color[5:7], 16))
    return tuple(int(c) for c in color)  # type: ignore[return-value]


def extract_seed_and_sigma(
    context: str, ignore_seed: int = -1
) -> Tuple[str, Optional[int], Optional[float]]:
    """Split optional trailing ``,seed[,sigma]`` off a context string."""
    parts = context.split(",")
    seed: Optional[int] = None
    sigma: Optional[float] = None
    if len(parts) > 2:
        try:
            s = int(parts[-2])
            sigma = float(parts[-1])
            parts = parts[:-2]
            seed = s
        except ValueError:
            try:
                seed = int(parts[-1])
                parts = parts[:-1]
            except ValueError:
                seed = None
        if seed == ignore_seed:
            seed = None
    return ",".join(parts), seed, sigma


def parse_context_entry(
    ctx: str, ignore_seed: int = -1
) -> Tuple[str, float, Optional[int], Optional[float]]:
    """Parse one context string → (label, strength, seed, sigma).

    Two separator conventions:
      * comma (reference core): ``"label,strength[,seed[,sigma]]"``
      * ``@`` (A1111 ControlNet+PwW extension, reference
        `README.md:403-405` — e.g. ``"aurora@0.5@-1"``):
        ``"label@strength[@seed[@sigma]]"``; labels may contain commas.
    """
    if "@" in ctx:
        # Try the @-form first, but fall back to the comma form when the
        # fields don't parse — a comma-form label may legitimately contain
        # '@' (e.g. "portrait by @greg,0.7"), and only the @-form has a
        # float in field 1.
        try:
            parts = [p.strip() for p in ctx.split("@")]
            label = parts[0]
            strength = float(parts[1])
            seed: Optional[int] = None
            sigma: Optional[float] = None
            if len(parts) > 2 and parts[2]:
                seed = int(parts[2])
                if seed == ignore_seed:
                    seed = None
            if len(parts) > 3 and parts[3]:
                sigma = float(parts[3])
            return label, strength, seed, sigma
        except (ValueError, IndexError):
            pass
    body, seed, sigma = extract_seed_and_sigma(ctx, ignore_seed)
    label = ",".join(body.split(",")[:-1])
    strength = float(body.split(",")[-1])
    return label, strength, seed, sigma


def separate_image_context(
    img: Optional[np.ndarray],
    color_context: Dict[ColorKey, str],
    tokenizer,
    ignore_seed: int = -1,
) -> Tuple[List[Region], int, int]:
    """Parse the full color context against a (H, W, 3) uint8 color map.

    Returns regions plus the PIL-convention (width, height) of the map.
    """
    regions: List[Region] = []
    if img is not None:
        h, w = img.shape[:2]
        parsed = []
        for color_key, ctx in color_context.items():
            label, strength, seed, blur_sigma = parse_context_entry(
                ctx, ignore_seed
            )
            token_ids = tokenizer(
                label, max_length=tokenizer.model_max_length, truncation=True
            )["input_ids"][1:-1]
            parsed.append(
                (parse_color(color_key), label, strength, token_ids, seed, blur_sigma)
            )
        if parsed:
            from ..native import color_masks

            colors = np.array([p[0] for p in parsed], np.uint8)
            strengths = np.array([p[2] for p in parsed], np.float32)
            masks, counts = color_masks(np.asarray(img), colors, strengths)
            for (color, label, strength, token_ids, seed, blur_sigma), mask, cnt in zip(
                parsed, masks, counts
            ):
                if cnt == 0:
                    warnings.warn(
                        f"color {color} not found in the color map image",
                        stacklevel=2,
                    )
                regions.append(
                    Region(
                        color=color, label=label, strength=strength,
                        token_ids=token_ids, mask=mask, seed=seed,
                        blur_sigma=blur_sigma,
                    )
                )
    else:
        w = h = 512

    if not regions:
        regions.append(
            Region(
                color=(0, 0, 0), label="", strength=0.0, token_ids=[-1],
                mask=np.zeros((h, w), np.float32),
            )
        )
    return regions, w, h


def token_match_matrix(
    regions: Sequence[Region], prompt_ids: Sequence[int], n_tokens: int
) -> np.ndarray:
    """(R, n_tokens) occurrence-count matrix.

    Entry ``[r, t] = k`` ⇔ token position ``t`` lies inside ``k`` substring
    occurrences of region ``r``'s token ids in the prompt — additive multi-
    occurrence semantics identical to the reference's ``+=`` loop.
    """
    from ..native import token_match_row

    ids = np.asarray(list(prompt_ids), np.int64)
    padded = np.zeros((n_tokens,), np.int64)
    padded[: len(ids)] = ids[:n_tokens]
    mat = np.zeros((len(regions), n_tokens), np.float32)
    for r, region in enumerate(regions):
        row, hits = token_match_row(padded[: len(ids)], region.token_ids)
        mat[r, : len(ids)] = row
        if hits == 0:
            warnings.warn(
                f"tokens {region.token_ids} ({region.label!r}) not found in prompt",
                stacklevel=2,
            )
    return mat
