"""Dense attention cores: PwW-biased cross-attention and plain attention.

Port of :mod:`pww_tpu.ops.attention`. This is the path for every attention
site the kernels do not take: the UNet's 8×8 mid block, sites below the
dispatch thresholds, CLIP, and custom weight functions.

Numerics preserved from the reference:
  * the bias is added to the *raw* logits before the 1/sqrt(d) scale:
    ``softmax((QKᵀ + bias) · scale)`` — not a post-scale additive mask;
  * the weight function's reduction runs over each sample's full
    (heads, q, k) score tensor, so under CFG batching the cond half never
    sees uncond scores.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .weight_functions import AnyWeightFunction, CustomWeightFunction


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> contiguous (B, H, L, dh)."""
    b, l, d = x.shape
    return x.view(b, l, num_heads, d // num_heads).transpose(1, 2).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, dh) -> (B, L, H*dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def pww_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias_w: Optional[torch.Tensor] = None,
    weight_fn: Optional[AnyWeightFunction] = None,
    sigma: Optional[torch.Tensor] = None,
    causal: bool = False,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention with an optional PwW additive logit bias.

    q, k, v: (B, H, Lq, dh) / (B, H, Lk, dh); ``bias_w``: (B, Lq, Lk) weight
    map broadcast over heads. Scores and softmax in f32; returns v's dtype.

    ``reduce``: scores (B, H, Lq, Lk) f32 → the structured weight function's
    per-sample reduction (B, 1, 1, 1); default ``weight_fn.reduce_qk``. The
    tensor-parallel UNet passes one that combines its heads' reduction with
    the other ranks'.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias_w is not None and weight_fn is not None:
        w = bias_w.float()[:, None]  # (B, 1, Lq, Lk)
        if isinstance(weight_fn, CustomWeightFunction):
            # each sample's callable sees only its own (H, Lq, Lk) scores
            bias = torch.stack([
                weight_fn(wi, sigma, si) for wi, si in zip(w, scores)
            ])
        else:
            r = (weight_fn.reduce_qk(scores, batch_axes=1) if reduce is None
                 else reduce(scores))  # (B,1,1,1)
            bias = weight_fn.sigma_coef(sigma).to(scores.device) * r * w
        scores = scores + bias
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)
