"""LayerNorm with f32 statistics, as the JAX package computes it unfused.

The JAX package's Pallas LayerNorm kernel (``pww_tpu/ops/layer_norm.py``,
off by default there) is not ported yet; this is the unfused composition
its ``_reference_layer_norm`` computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, cast back to ``x``'s dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)
