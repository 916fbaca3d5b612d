"""Bilinear / nearest resize with torch ``F.interpolate`` index semantics.

Port of :mod:`pww_tpu.ops.resize`: the same gathers and lerps in the same
order, so the port's bias pyramid matches the JAX package's to the bit on
f32 inputs. Used by mask rasterization (``align_corners=True``), the ORIG
weight fallback (bilinear + 1-D nearest) and regional-seed masks
(``align_corners=False``).
"""
from __future__ import annotations

import torch


def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   device) -> torch.Tensor:
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return i * ((in_size - 1) / (out_size - 1))
    # torch: src = (dst + 0.5) * scale - 0.5, clamped at 0 below
    return torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)


def _axis_weights(out_size: int, in_size: int, align_corners: bool, device):
    src = _source_coords(out_size, in_size, align_corners, device)
    lo = torch.clamp(torch.floor(src).long(), 0, in_size - 1)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, src - lo.float()


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize over the last two axes (any leading dims)."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    x = img.float()
    ylo, yhi, wy = _axis_weights(out_h, in_h, align_corners, img.device)
    xlo, xhi, wx = _axis_weights(out_w, in_w, align_corners, img.device)
    top = x.index_select(-2, ylo)
    bot = x.index_select(-2, yhi)
    rows = top + (bot - top) * wy[:, None]
    left = rows.index_select(-1, xlo)
    right = rows.index_select(-1, xhi)
    return (left + (right - left) * wx).to(img.dtype)


def resize_nearest_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """1-D nearest resize over the last axis (torch ``mode='nearest'``)."""
    in_len = x.shape[-1]
    idx = torch.arange(out_len, dtype=torch.float32, device=x.device)
    idx = torch.clamp((idx * (in_len / out_len)).long(), max=in_len - 1)
    return x.index_select(-1, idx)
