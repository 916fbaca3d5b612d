"""GroupNorm with f32 statistics, as the JAX package computes it unfused.

The JAX package's Pallas GroupNorm kernel (``pww_tpu/ops/group_norm.py``,
off by default there) is not ported yet; this is the unfused composition
its ``_reference_group_norm`` computes: optional pre-add in the input
dtype, f32 stats and affine, optional SiLU, cast back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def group_norm_f32(gn: nn.GroupNorm, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ optional SiLU) in f32, cast back to ``x``'s dtype."""
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return (F.silu(y) if silu else y).to(x.dtype)
