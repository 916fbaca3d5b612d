"""The reference's layers, in float32 or in a simulated lower precision.

Every matrix product of the reference (each linear layer, each convolution
and both products of every attention) goes through these classes. With
``fp8`` set on a layer its operands are rounded to float8 e4m3 with one
scale per tensor (the largest magnitude mapped to 448), and the product is
taken in float32, which is what an fp8 tensor-core GEMM with a float32
accumulator computes. That is the benchmark's control: the reference one
precision step below the bfloat16 the configurations state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    x = x.float()
    amax = x.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = fp8_round(a), fp8_round(b)
    return torch.matmul(a, b)


def set_fp8(model: nn.Module, on: bool) -> None:
    """Switch every product of ``model`` to the fp8 control, or back."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)) or hasattr(m, "fp8_attention"):
            if isinstance(m, (Linear, Conv2d)):
                m.fp8 = on
            else:
                m.fp8_attention = on
