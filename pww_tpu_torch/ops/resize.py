"""Bilinear / nearest resize with torch ``F.interpolate`` index semantics.

Port of :mod:`pww_tpu.ops.resize`: the same gathers and lerps in the same
order, so the port's bias pyramid matches the JAX package's to the bit on
f32 inputs. Used by mask rasterization (``align_corners=True``), the ORIG
weight fallback (bilinear + 1-D nearest), regional-seed masks
(``align_corners=False``) and the inpaint mask on the latent grid (2-D
nearest). :func:`resize_linear_antialias` is ``jax.image.resize(...,
method="linear")``, which the legacy inpaint path takes to its latent mask.
"""
from __future__ import annotations

import numpy as np
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


def _nearest_index(out_len: int, in_len: int, device) -> torch.Tensor:
    idx = torch.arange(out_len, dtype=torch.float32, device=device)
    return torch.clamp((idx * (in_len / out_len)).long(), max=in_len - 1)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize over the last two axes (torch ``'nearest'``)."""
    ys = _nearest_index(out_h, img.shape[-2], img.device)
    xs = _nearest_index(out_w, img.shape[-1], img.device)
    return img.index_select(-2, ys).index_select(-1, xs)


def _triangle_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) weights of ``jax.image.resize``'s "linear" method
    (``jax._src.image.scale.compute_weight_mat``, antialiased): a triangle
    kernel widened by the downsampling factor, normalized per output."""
    scale = np.float32(out_len / in_len)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(out_len, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_len, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear_antialias(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize over the last two axes as ``jax.image.resize(method="linear")``
    does, antialiasing included: when it shrinks, each output averages the
    inputs under a triangle as wide as the factor (a plain bilinear
    ``F.interpolate`` samples only the two nearest)."""
    x = img.float()
    if out_h != x.shape[-2]:
        wy = torch.from_numpy(_triangle_weights(x.shape[-2], out_h)).to(x.device)
        x = torch.matmul(x.transpose(-1, -2), wy).transpose(-1, -2)
    if out_w != x.shape[-1]:
        wx = torch.from_numpy(_triangle_weights(x.shape[-1], out_w)).to(x.device)
        x = torch.matmul(x, wx)
    return x.to(img.dtype)
