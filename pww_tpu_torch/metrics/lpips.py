"""LPIPS (Zhang et al. 2018, "The Unreasonable Effectiveness of Deep
Features as a Perceptual Metric"), AlexNet backbone, in PyTorch.

Port of :mod:`pww_tpu.metrics.lpips`, with its own copy of the constants.
The parameters are a dict of tensors on one device: ``conv{i}_w`` (OIHW,
torch's layout), ``conv{i}_b`` and ``lin{i}_w`` (C,), i = 0..4, loaded from
the standard torch weight files:

* a torchvision AlexNet ``state_dict`` (``features.{0,3,6,8,10}.weight``)
* the LPIPS linear-calibration ``state_dict``
  (``lin{0..4}.model.1.weight``, the official ``alex.pth``)

Semantics follow the reference implementation (v0.1): fixed input shift /
scale, features taken after each of the five ReLUs, channel-unit-
normalization with eps added to the norm, squared difference, 1x1 linear
weighting, spatial mean, sum over layers. The convolutions are
``torch.nn.functional.conv2d`` (the JAX package computes them outside any
Pallas kernel). The loaders place the parameters on the card unless the
caller names the CPU; :func:`lpips_distance` runs where they are.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# LPIPS ScalingLayer constants (official v0.1)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision AlexNet `features` conv specs: (out_ch, kernel, stride, pad)
_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
# maxpool(3, 2) sits AFTER the relu of conv index in this set
_POOL_AFTER = (0, 1)


def _device(device) -> torch.device:
    from ..pipeline.pipeline import resolve_device

    return resolve_device(device)


def _features(params: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """Five post-ReLU AlexNet feature maps (NCHW). ``x``: (N, 3, H, W) in [-1, 1]."""
    shift = torch.from_numpy(_SHIFT).to(x.device).view(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    feats = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=stride, padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    # official normalize_tensor: x / (||x||_ch + 1e-10)
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (norm + 1e-10)


@torch.no_grad()
def lpips_distance(params: Dict[str, torch.Tensor], a, b) -> torch.Tensor:
    """LPIPS(a, b) per sample, (N,) f32 on the parameters' device. Inputs
    (N, H, W, 3) float in [-1, 1]: tensors or arrays."""
    dev = params["conv0_w"].device

    def nchw(x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        return x.to(device=dev, dtype=torch.float32).permute(0, 3, 1, 2)

    total = 0.0
    for i, (x, y) in enumerate(zip(_features(params, nchw(a)), _features(params, nchw(b)))):
        d = (_unit_normalize(x) - _unit_normalize(y)) ** 2  # (N, C, H, W)
        w = params[f"lin{i}_w"].view(1, -1, 1, 1)  # nonneg calibration weights
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total


def load_lpips_from_torch_state(alexnet_sd: Dict, lin_sd: Dict,
                                device="cuda") -> Dict[str, torch.Tensor]:
    """The parameter dict from torch state dicts, f32 on ``device``.

    ``alexnet_sd``: torchvision AlexNet (only ``features.*`` used);
    ``lin_sd``: official LPIPS linear weights — accepts both
    ``lin{i}.model.1.weight`` (file layout) and ``lins.{i}.model.1.weight``
    (module layout) keys.
    """
    dev = _device(device)

    def f32(t):
        return torch.as_tensor(t).detach().to(device=dev, dtype=torch.float32)

    params = {}
    for i, j in enumerate((0, 3, 6, 8, 10)):  # conv positions in torchvision features
        params[f"conv{i}_w"] = f32(alexnet_sd[f"features.{j}.weight"])  # (O, I, kh, kw)
        params[f"conv{i}_b"] = f32(alexnet_sd[f"features.{j}.bias"])
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin_sd:
                params[f"lin{i}_w"] = f32(lin_sd[key]).reshape(-1)  # (1, C, 1, 1) → (C,)
                break
        else:
            raise KeyError(f"lin{i} weight not found in LPIPS state dict")
    return params


def load_lpips_from_files(backbone_path: str, lin_path: str,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Load from torch ``.pth`` files on disk (no network access)."""
    alexnet_sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    return load_lpips_from_torch_state(alexnet_sd, lin_sd, device)


def init_random_lpips(seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random-weight instance (testing / plumbing checks only — random
    features are NOT a calibrated perceptual metric): the JAX package's
    numpy draws, its HWIO kernels turned to OIHW."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_CONVS):
        w = (rng.standard_normal((k, k, in_ch, out_ch)).astype(np.float32)
             * (2.0 / (k * k * in_ch)) ** 0.5)
        params[f"conv{i}_w"] = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dev)
        params[f"conv{i}_b"] = torch.from_numpy(
            rng.standard_normal(out_ch).astype(np.float32) * 0.01).to(dev)
        params[f"lin{i}_w"] = torch.from_numpy(
            rng.uniform(0.0, 1.0, out_ch).astype(np.float32)).to(dev)
        in_ch = out_ch
    return params
