"""Paint-with-words weight functions, on torch tensors.

Port of :mod:`pww_tpu.ops.weight_functions`. The reference's free-form
``weight_function(w, sigma, qk)`` splits into a sigma coefficient and a
per-sample reduction of the scores, so that
``bias = sigma_coef(sigma) · reduce(QKᵀ) · w``; arbitrary callables stay
available through :class:`CustomWeightFunction`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

SIGMA_MODES = ("log1p_sigma", "log1p_sigma2", "one")
REDUCE_MODES = ("max", "std", "mean", "one")


@dataclasses.dataclass(frozen=True)
class WeightFunction:
    """``bias = scale · g(sigma) · reduce(QKᵀ) · w``.

    ``reduce`` runs over each batch element's full (heads, q, k) score
    tensor in float32; ``std`` is unbiased (n − 1), as ``torch.Tensor.std``.
    """

    scale: float = 0.1
    sigma_mode: str = "log1p_sigma"  # g(σ): log(1+σ) | log(1+σ²) | 1
    reduce_mode: str = "max"  # reduce(QKᵀ): max | std | mean | 1

    def __post_init__(self):
        if self.sigma_mode not in SIGMA_MODES:
            raise ValueError(f"sigma_mode must be one of {SIGMA_MODES}")
        if self.reduce_mode not in REDUCE_MODES:
            raise ValueError(f"reduce_mode must be one of {REDUCE_MODES}")

    def sigma_coef(self, sigma) -> torch.Tensor:
        """f32 tensor; stays on ``sigma``'s device (no host sync)."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        if self.sigma_mode == "log1p_sigma":
            g = torch.log1p(sigma)
        elif self.sigma_mode == "log1p_sigma2":
            g = torch.log1p(sigma * sigma)
        else:
            g = torch.ones_like(sigma)
        return self.scale * g

    def reduce_qk(self, qk: torch.Tensor, batch_axes: int = 1) -> torch.Tensor:
        """Reduce over all but the leading ``batch_axes`` axes, kept as size 1."""
        axes = tuple(range(batch_axes, qk.ndim))
        x = qk.float()
        if self.reduce_mode == "one":
            return torch.ones(
                qk.shape[:batch_axes] + (1,) * (qk.ndim - batch_axes),
                dtype=torch.float32, device=qk.device,
            )
        if self.reduce_mode == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        if self.reduce_mode == "mean":
            return torch.mean(x, dim=axes, keepdim=True)
        n = 1
        for a in axes:
            n *= qk.shape[a]
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.sum((x - mean) ** 2, dim=axes, keepdim=True) / max(n - 1, 1)
        return torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class CustomWeightFunction:
    """Wraps an arbitrary ``f(w, sigma, qk) -> bias`` callable (torch ops)."""

    fn: Callable

    def __call__(self, w, sigma, qk):
        return self.fn(w, sigma, qk)


AnyWeightFunction = Union[WeightFunction, CustomWeightFunction]

# The reference's txt2img default: 0.1 · w · log(1+σ) · max(QKᵀ)
DEFAULT_TXT2IMG = WeightFunction(scale=0.1, sigma_mode="log1p_sigma", reduce_mode="max")


def as_weight_function(
    f: Optional[Union[AnyWeightFunction, Callable]],
) -> AnyWeightFunction:
    """Coerce user input (None | WeightFunction | raw callable) to the API type."""
    if f is None:
        return DEFAULT_TXT2IMG
    if isinstance(f, (WeightFunction, CustomWeightFunction)):
        return f
    if callable(f):
        return CustomWeightFunction(fn=f)
    raise TypeError(f"not a weight function: {f!r}")
