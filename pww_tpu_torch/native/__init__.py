"""numpy host ops: color-map masks and prompt token matching.

The numpy twins of :mod:`pww_tpu.native`'s ``color_masks`` and
``token_match_row``. The C++ host library there is not ported yet; these
compute the same results.
"""
from __future__ import annotations

from typing import Tuple

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
