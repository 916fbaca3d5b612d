"""Inpainting mask and masked-image preparation, and the A1111-style helpers.

Host-side copy of :mod:`pww_tpu.pipeline.inpaint` in numpy: the reference's
validation and normalization (image to [-1, 1], mask binarized at 0.5,
``masked_image = image · (mask < 0.5)``), the gaussian mask feather, the
masked-content "fill", and the crop and paste of ``inpaint_full_res``.
Arrays are channel-last, as in the JAX package; the pipeline moves them to
NCHW tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _to_nhwc_float(image) -> np.ndarray:
    """PIL / numpy image → (B, H, W, C) float32."""
    from PIL import Image

    if isinstance(image, Image.Image):
        return (np.asarray(image.convert("RGB"), np.float32) / 127.5 - 1.0)[None]
    arr = np.asarray(image, np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.shape[-1] not in (1, 3):
        raise ValueError(f"expected channel-last image, got shape {arr.shape}")
    return arr


def prepare_mask_and_masked_image(image, mask) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(mask (B,H,W,1) in {0,1}, masked_image (B,H,W,3) in [-1,1])``,
    validating ranges and shapes like the reference (inpaint.py:53-101)."""
    from PIL import Image

    img = _to_nhwc_float(image)
    if img.min() < -1.0 - 1e-4 or img.max() > 1.0 + 1e-4:
        raise ValueError("image should be in [-1, 1] range")
    if isinstance(mask, Image.Image):
        m = (np.asarray(mask.convert("L"), np.float32) / 255.0)[None, :, :, None]
    else:
        m = np.asarray(mask, np.float32)
        if m.ndim == 2:
            m = m[None, :, :, None]
        elif m.ndim == 3:
            m = m[..., None] if m.shape[-1] != 1 else m[None]
    if m.min() < 0.0 or m.max() > 1.0:
        raise ValueError("mask should be in [0, 1] range")
    if m.shape[1:3] != img.shape[1:3]:
        raise ValueError(f"mask spatial size {m.shape[1:3]} != image {img.shape[1:3]}")
    m = (m >= 0.5).astype(np.float32)
    return m, img * (m < 0.5)


def _gauss2d(arr: np.ndarray, sigma: float) -> np.ndarray:
    """Separable 2-D gaussian of a (H, W) float array, edge-padded, not
    clipped: a kernel truncated at radius max(int(3σ), 1), normalized to sum
    1, applied per axis with edge replication."""
    from scipy.ndimage import convolve1d

    radius = max(int(3 * sigma), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    m = np.asarray(arr, np.float32)
    m = convolve1d(m, k, axis=0, mode="nearest")
    m = convolve1d(m, k, axis=1, mode="nearest")
    return m.astype(np.float32)


def blur_mask(mask: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-feather a (H, W) float mask (A1111 ``mask_blur``); float32
    in [0, 1], the mask itself for sigma ≤ 0."""
    if sigma <= 0:
        return np.asarray(mask, np.float32)
    return np.clip(_gauss2d(mask, sigma), 0.0, 1.0)


def fill_masked_region(image: np.ndarray, hole: np.ndarray) -> np.ndarray:
    """Replace ``hole`` pixels with colors diffused in from around them
    (A1111 ``masked content: fill``): normalized convolution at widening
    radii. ``image`` (H, W, 3) float in [-1, 1]; ``hole`` (H, W), 1 = fill.
    Returns a new (H, W, 3) float32 array."""
    img = np.asarray(image, np.float32).copy()
    hole = np.asarray(hole).astype(bool)
    if not hole.any():
        return img
    keep = (~hole).astype(np.float32)
    if not keep.any():  # fully masked: the global mean color
        img[:] = img.mean(axis=(0, 1), keepdims=True)
        return img
    out = img * keep[..., None]
    w = keep
    for sigma in (4.0, 16.0, 64.0):
        bw = _gauss2d(w, sigma)
        bi = np.stack([_gauss2d(out[..., c], sigma) for c in range(img.shape[-1])],
                      axis=-1)
        filled = bi / np.maximum(bw[..., None], 1e-3)
        known = bw > 1e-3  # firm support only: tiny tails amplify noise
        upd = hole & known & (w <= 0)
        img[upd] = np.clip(filled[upd], -1.0, 1.0)
        w = np.maximum(w, known.astype(np.float32))
        out = img * w[..., None]
    left = hole & (w <= 0)  # still unreached (pathological masks): global mean
    if left.any():
        img[left] = img[~hole].mean(axis=0)
    return img


def expand_crop_region(mask: np.ndarray, padding: int, target_w: int,
                       target_h: int) -> Tuple[int, int, int, int]:
    """Crop region for ``inpaint_full_res``: the mask's bounding box grown by
    ``padding`` pixels, then widened or heightened to the processing aspect
    ``target_w:target_h``, shifted inward at the borders. Returns half-open
    ``(x0, y0, x1, y1)``; the whole image for an empty mask."""
    m = np.asarray(mask)
    h, w = m.shape
    ys, xs = np.nonzero(m >= 0.5)
    if len(ys) == 0:
        return 0, 0, w, h
    x0 = max(int(xs.min()) - padding, 0)
    x1 = min(int(xs.max()) + 1 + padding, w)
    y0 = max(int(ys.min()) - padding, 0)
    y1 = min(int(ys.max()) + 1 + padding, h)

    ratio_crop = (x1 - x0) / (y1 - y0)
    ratio_proc = target_w / target_h
    if ratio_crop < ratio_proc:  # too narrow: widen
        want = min(int(round((y1 - y0) * ratio_proc)), w)
        extra = want - (x1 - x0)
        x0 -= extra // 2
        x1 += extra - extra // 2
        if x0 < 0:
            x1 = min(x1 - x0, w)
            x0 = 0
        elif x1 > w:
            x0 = max(x0 - (x1 - w), 0)
            x1 = w
    elif ratio_crop > ratio_proc:  # too wide: heighten
        want = min(int(round((x1 - x0) / ratio_proc)), h)
        extra = want - (y1 - y0)
        y0 -= extra // 2
        y1 += extra - extra // 2
        if y0 < 0:
            y1 = min(y1 - y0, h)
            y0 = 0
        elif y1 > h:
            y0 = max(y0 - (y1 - h), 0)
            y1 = h
    return x0, y0, x1, y1


def paste_region(full: np.ndarray, patch: np.ndarray, region: Tuple[int, int, int, int],
                 mask: np.ndarray) -> np.ndarray:
    """Paste ``patch`` into ``full`` (H, W, 3) uint8 at ``region`` = (x0, y0,
    x1, y1), blended by the (H, W) float ``mask``; ``patch`` is resized to
    the region (LANCZOS) if its size differs."""
    from PIL import Image

    x0, y0, x1, y1 = region
    out = np.asarray(full, np.uint8).copy()
    p = np.asarray(patch)
    if p.shape[:2] != (y1 - y0, x1 - x0):
        p = np.asarray(Image.fromarray(p.astype(np.uint8)).resize(
            (x1 - x0, y1 - y0), Image.LANCZOS))
    m = np.asarray(mask, np.float32)[y0:y1, x0:x1, None]
    blend = out[y0:y1, x0:x1].astype(np.float32) * (1.0 - m) + p.astype(np.float32) * m
    out[y0:y1, x0:x1] = np.clip(np.round(blend), 0, 255).astype(np.uint8)
    return out
