"""Separable Gaussian blur matching ``torchvision.transforms.GaussianBlur``.

Port of :mod:`pww_tpu.ops.blur`: a normalized sampled-Gaussian 1-D kernel
applied along each of the last two axes with *reflect* padding, as the
reference blurs region masks (fixed 39-tap kernel, per-region sigma).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32, device=device)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    return pdf / pdf.sum()


def gaussian_blur(img: torch.Tensor, kernel_size: int = 39,
                  sigma: float = 1.0) -> torch.Tensor:
    """Blur the last two axes of ``img`` (any leading batch dims)."""
    k = gaussian_kernel_1d(kernel_size, sigma, img.device)
    pad = kernel_size // 2
    h, w = img.shape[-2], img.shape[-1]
    x = img.float().reshape(-1, 1, h, w)
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, kernel_size))
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="reflect"),
                 k.view(1, 1, kernel_size, 1))
    return x.reshape(img.shape).to(img.dtype)
