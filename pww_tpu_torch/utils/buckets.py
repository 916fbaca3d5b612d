"""Resolution buckets: bounding the sizes a server runs at.

Port of :mod:`pww_tpu.utils.buckets`. The reference accepts any width and
height from its 256-1024 sliders (reference `gradio_pww.py:96-99`); the
server snaps each request to a lattice of multiples of 64 (the VAE's 8×
factor times the UNet's 8× downsampling) and resizes the color map and the
init image to it. The JAX package does so to compile one program per
bucket; eagerly on the card it keeps the requests that can share a batch in
few groups.
"""
from __future__ import annotations

from typing import Tuple


def snap_resolution(width: int, height: int, multiple: int = 64, min_side: int = 256,
                    max_side: int = 1024) -> Tuple[int, int]:
    """The nearest bucket (rounded to the nearest multiple, clamped)."""

    def snap(x: int) -> int:
        x = max(min_side, min(max_side, x))
        return int(round(x / multiple) * multiple) or multiple

    return snap(width), snap(height)


def bucket_count(multiple: int = 64, min_side: int = 256, max_side: int = 1024) -> int:
    per_axis = (max_side - min_side) // multiple + 1
    return per_axis * per_axis
