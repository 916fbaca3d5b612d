"""Weights drawn from the seed on the device, in a few large calls.

One ``torch.randn`` fills one bfloat16 buffer (the type the program
serves in) from ``torch.Generator(device).manual_seed(seed)``; every
tensor of every part is a view into it, laid out so that tensors of one
scale sit side by side and one multiply scales each run of them:

* a norm's weight: 1 + 0.02·z;
* a bias or a norm's shift: 0.02·z;
* a matrix or a convolution kernel: z / sqrt(fan-in), so that every layer
  keeps its activations near unit size, as trained weights do, and the
  image and the ε pair carry signal that a lower precision disturbs.

The names and shapes come from the reference's modules on the meta device,
which carry the program's parameter names. Each tensor starts on a
256-byte boundary, as a tensor allocated alone does: cuBLAS and cuDNN
take slower kernels for operands that are not aligned.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 128  # elements: 256 bytes of bfloat16


def _scale(key: str, shape: Tuple[int, ...]):
    """(multiplier, offset) of the standard normal for one tensor."""
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if "norm" in key and key.endswith(".weight"):
        return 0.02, 1.0
    return 0.02, 0.0


def draw(shapes: Dict[str, Dict[str, torch.Size]], seed: int, device,
         dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """(the flat buffer, {part: {key: view}}) for ``shapes`` {part: {key: shape}}."""
    items: List[Tuple[Tuple[float, float], str, str, torch.Size]] = [
        (_scale(k, tuple(s)), part, k, s) for part, sd in shapes.items() for k, s in sd.items()]
    items.sort(key=lambda it: it[0])
    total = sum(_padded(math.prod(s)) for *_, s in items)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    params: Dict[str, Dict[str, torch.Tensor]] = {part: {} for part in shapes}
    off, run_start, run_scale = 0, 0, None
    for scale, part, key, shape in items:
        if scale != run_scale:
            _apply(flat[run_start:off], run_scale)
            run_start, run_scale = off, scale
        n = math.prod(shape)
        params[part][key] = flat[off:off + n].view(shape)
        off += _padded(n)
    _apply(flat[run_start:off], run_scale)
    return flat, params


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _apply(run: torch.Tensor, scale) -> None:
    if scale is None or run.numel() == 0:
        return
    mul, add = scale
    run.mul_(mul)
    if add:
        run.add_(add)


def shapes_of(models: Dict[str, torch.nn.Module]) -> Dict[str, Dict[str, torch.Size]]:
    return {part: {k: v.shape for k, v in m.state_dict().items()} for part, m in models.items()}
