"""K4: GroupNorm with an optional pre-add and SiLU, and its plain version.

Port of :mod:`pww_tpu.ops.group_norm`. :func:`group_norm` computes, for
each sample and group of channels,

  * ``x + add`` rounded to x's dtype (the ResNet time-embedding shift),
  * the f32 mean and the fast variance ``E[x²] − μ²`` clamped at 0,
  * ``(x − μ) · rsqrt(var + eps) · weight + bias``, then SiLU if asked, in
    f32, cast to ``out_dtype``.

Layout: the JAX function takes channel-last ``(N, *spatial, C)``; this one
takes NCHW ``(N, C, *spatial)``, the layout of the port's models. There a
group's ``(C/G)·HW`` elements lie contiguous in memory, so the kernel reads
each group as one flat span. The wrapper takes the plain version for
tensors on the CPU and launches the CUDA kernel (``csrc/group_norm.cu``,
statistics then apply, two launches) for contiguous bf16 tensors on the
card; anything else raises. Launches are counted in ``group_norm.launches``.

:func:`group_norm_f32` is the unfused composition (``F.group_norm`` in f32,
another variance formula) that the models run while the kernel's knob is
off.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int


def group_norm_f32(gn: nn.GroupNorm, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ optional SiLU) in f32, cast back to ``x``'s dtype."""
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return (F.silu(y) if silu else y).to(x.dtype)


def _with_add(x: torch.Tensor, add: Optional[torch.Tensor]) -> torch.Tensor:
    if add is None:
        return x
    return x + add.to(x.dtype).reshape(add.shape[:2] + (1,) * (x.dim() - 2))


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                     groups: int, eps: float, silu: bool = False,
                     add: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain K4 on NCHW ``x``, as ``pww_tpu/ops/group_norm.py:
    _reference_group_norm`` (flax ``GroupNorm``) computes it."""
    n, c = x.shape[:2]
    xf = _with_add(x, add).float().reshape(n, groups, c // groups, -1)
    mean = xf.mean((2, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean((2, 3), keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float().reshape(1, groups, -1, 1)
    y = (xf - mean) * mul + bias.float().reshape(1, groups, -1, 1)
    if silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(out_dtype or x.dtype)


@functools.cache
def _chunk_elems() -> int:
    """Elements of a group per statistics partial, a constant of
    ``csrc/group_norm.cu``."""
    return cuda_build.function("group_norm_chunk_elems", [])()


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float, silu: bool = False,
               add: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K4: GroupNorm over NCHW ``x`` (N, C, *spatial).

    ``add`` (N, C) is added in x's dtype before the statistics; ``weight``
    and ``bias`` are (C,), f32 or bf16; the result has ``out_dtype``
    (default x's dtype; the kernel writes bf16 or f32).
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups=groups, eps=eps, silu=silu,
                                add=add, out_dtype=out_dtype)
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"group_norm: the CUDA kernel takes contiguous bf16 NCHW on "
                         f"the card, got {x.dtype} on {x.device}")
    if x.dim() < 3 or c % groups or x.data_ptr() % 16:
        raise ValueError(f"group_norm: {tuple(x.shape)} with {groups} groups")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm: the kernel writes bf16 or f32, not {out_dtype}")
    params = []
    for p in (weight, bias):
        if p.shape != (c,) or p.device != x.device or p.dtype not in (torch.float32,
                                                                       torch.bfloat16):
            raise ValueError(f"group_norm: weight and bias must be ({c},) f32 or bf16 "
                             f"on {x.device}")
        params.append(p.contiguous())
    if params[0].dtype != params[1].dtype:
        params[1] = params[1].to(params[0].dtype)
    if add is not None:
        if add.shape != (n, c) or add.device != x.device:
            raise ValueError(f"group_norm: add must be ({n}, {c}) on {x.device}")
        add = add.to(torch.bfloat16).contiguous()
    span = (c // groups) * hw  # one group's elements
    nchunk = -(-span // _chunk_elems())
    part = torch.empty((n * groups * nchunk, 2), dtype=torch.float32, device=x.device)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = cuda_build.function("group_norm", [_P] * 6 + [_I] * 4 + [ctypes.c_float]
                             + [_I] * 3 + [_P])
    err = fn(x.data_ptr(), 0 if add is None else add.data_ptr(), params[0].data_ptr(),
             params[1].data_ptr(), part.data_ptr(), out.data_ptr(), n, c, hw, groups,
             eps, int(silu), int(params[0].dtype == torch.bfloat16),
             int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "group_norm")
    group_norm.launches += 1
    return out


group_norm.launches = 0


def group_norm_site(gn: nn.GroupNorm, x: torch.Tensor, *, fused: bool,
                    silu: bool = False, add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A model's GroupNorm site: K4 (on a contiguous copy of x if it is not
    contiguous) when ``fused``, else the pre-add in x's dtype followed by
    :func:`group_norm_f32`. The result has x's dtype."""
    if fused:
        return group_norm(x.contiguous(), gn.weight, gn.bias, groups=gn.num_groups, eps=gn.eps,
                          silu=silu, add=add)
    return group_norm_f32(gn, _with_add(x, add), silu=silu)
