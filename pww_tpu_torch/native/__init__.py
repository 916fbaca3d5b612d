"""numpy host ops: color-map masks, the apps' color tools and prompt token
matching.

The numpy twins of :mod:`pww_tpu.native`'s ``color_masks``,
``color_mask_sqdist``, ``unique_colors`` and ``token_match_row`` (its numpy
branches, ``pww_tpu/native/__init__.py:80-166``). The C++ host library
there is not ported yet (ROADMAP A.19b); these compute the same results.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def color_masks(
    img: np.ndarray, colors: np.ndarray, strengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(N,H,W) strength-scaled exact-match masks + per-color pixel counts."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    strengths = np.ascontiguousarray(strengths, np.float32)
    n = len(colors)
    eq = (img[None] == colors[:, None, None]).all(-1)
    return (
        eq.astype(np.float32) * strengths[:, None, None],
        eq.reshape(n, -1).sum(-1).astype(np.int64),
    )


def color_mask_sqdist(img: np.ndarray, color, threshold: int = 30) -> np.ndarray:
    """(H, W) bool: pixels within squared RGB distance ``threshold`` of ``color``."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    diff = img.astype(np.int64) - np.asarray(color, np.int64)
    return (diff * diff).sum(-1) < threshold


def unique_colors(img: np.ndarray, min_fraction: float = 0.01,
                  max_out: int = 8) -> List[Tuple[Tuple[int, int, int], int]]:
    """Up to ``max_out`` (color, pixel count) pairs, most common first, of the
    colors covering more than ``min_fraction`` of the image."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    h, w = img.shape[:2]
    min_count = max(1, int(min_fraction * h * w) + 1)
    colors, counts = np.unique(img.reshape(-1, 3), axis=0, return_counts=True)
    res = []
    for i in np.argsort(-counts)[:max_out]:
        if counts[i] < min_count:
            break
        res.append((tuple(int(x) for x in colors[i]), int(counts[i])))
    return res


def token_match_row(ids, sub) -> Tuple[np.ndarray, int]:
    """Occurrence-count row over prompt positions (overlap-additive)."""
    ids = np.ascontiguousarray(ids, np.int64)
    sub = list(np.ascontiguousarray(sub, np.int64))
    row = np.zeros((len(ids),), np.float32)
    hits = 0
    for i in range(len(ids) - len(sub) + 1):
        if list(ids[i : i + len(sub)]) == sub:
            hits += 1
            row[i : i + len(sub)] += 1.0
    return row, hits
