"""Typed PwW conditioning state, passed to the UNet as a plain argument.

Port of :mod:`pww_tpu.types`. The reference smuggles a dict keyed by
strings like ``CROSS_ATTENTION_WEIGHT_4096`` through
``encoder_hidden_states``; here it is a dataclass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .ops.resize import resize_bilinear, resize_nearest_1d
from .ops.weight_functions import AnyWeightFunction, WeightFunction


@dataclasses.dataclass(frozen=True)
class PwwState:
    """Per-call paint-with-words conditioning.

    Attributes:
      weights: bias pyramid keyed by flattened spatial size ``h·w`` at each
        UNet attention resolution → (B, h·w, n_text_tokens) f32 tensors.
        Unconditional batch rows are all-zero.
      weight_orig: (B, H, W, n_text_tokens) full-resolution map, the resize
        fallback for attention resolutions missing from ``weights``.
      sigma: current scheduler sigma, 0-d f32 tensor on the weights' device.
      weight_fn: the weight function.
    """

    weights: Dict[int, torch.Tensor]
    weight_orig: Optional[torch.Tensor]
    sigma: torch.Tensor
    weight_fn: AnyWeightFunction = WeightFunction()

    def bias_for(self, q_len: int) -> Optional[torch.Tensor]:
        """(B, q_len, n_tokens) weight map for an attention site, or None.

        The reference's size-keyed lookup, with its ORIG fallback: bilinear
        (align_corners=True) to the floored size, then 1-D nearest to q_len.
        """
        if q_len in self.weights:
            return self.weights[q_len]
        if self.weight_orig is None:
            return None
        b, h, w, nc = self.weight_orig.shape
        ratio = (h * w / q_len) ** 0.5
        # torch F.interpolate(scale_factor=1/ratio) floors the output size.
        h2, w2 = int(h / ratio), int(w / ratio)
        x = self.weight_orig.permute(0, 3, 1, 2)  # (B, nc, H, W)
        x = resize_bilinear(x, h2, w2, align_corners=True)
        x = resize_nearest_1d(x.reshape(b, nc, h2 * w2), q_len)
        return x.permute(0, 2, 1).contiguous()  # (B, q_len, nc)

    def with_sigma(self, sigma: torch.Tensor) -> "PwwState":
        return dataclasses.replace(self, sigma=sigma)


@dataclasses.dataclass(frozen=True)
class IpState:
    """IP-Adapter image conditioning, the decoupled cross-attention's operand
    (``pww_tpu/types.py:65-76``).

    Attributes:
      tokens: (B, n_ip, D_ctx) projected image-prompt tokens, the CFG rows
        [uncond*N, cond*N]; the uncond rows hold the projection of the zero
        image embedding (the plus variant: of the zero image through the
        encoder).
      scale: the image branch's multiplier, a float.
    """

    tokens: torch.Tensor
    scale: float

    def rows(self, index) -> "IpState":
        """The state for a slice of the batch rows (a CFG half, the uncond
        rows of SAG's degraded pass)."""
        return dataclasses.replace(self, tokens=self.tokens[index])
