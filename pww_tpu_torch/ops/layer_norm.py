"""K5: per-token LayerNorm, and its plain version.

Port of :mod:`pww_tpu.ops.layer_norm`. :func:`layer_norm` normalizes over
the last dim with f32 statistics and the fast variance ``E[x²] − μ²``
clamped at 0, applies the affine in f32 and casts to ``out_dtype``. The
wrapper takes the plain version for tensors on the CPU and launches the
CUDA kernel (``csrc/layer_norm.cu``: a group of lanes per row, each lane
owning whole 16-byte column vectors of the row in registers, w and b loaded
once per lane; :func:`layer_norm_plan` sizes it) for contiguous bf16
tensors on the card; anything else raises, inputs that require a gradient
under grad mode among them (the kernel has no backward). Launches are
counted in ``layer_norm.launches``.

:func:`layer_norm_site` is a UNet transformer block's LayerNorm site. It
runs K5 where :func:`~pww_tpu_torch.ops.cuda_build.norm_site_takes_kernel`
holds (bf16 on the card, no gradient recorded through it) and the width is
one the kernel takes, and everywhere when the config's ``fused_layer_norm``
knob is on (the plain K5 on the CPU). Everything else runs
:func:`layer_norm_f32`, the unfused composition (``F.layer_norm`` in f32),
as the text and image encoders always do.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build

MAX_WIDTH = 2048  # the kernel keeps a row of at most this many values in registers
MAX_VPT = 8  # 16-byte vectors of a row per lane
SMS = 132  # the H100 SXM's SMs


class LayerNormPlan(NamedTuple):
    """How ``csrc/layer_norm.cu`` covers (rows, C)."""

    lanes: int  # lanes per row, a power of two up to 32
    vpt: int  # 16-byte column vectors per lane
    threads: int  # per CTA
    grid: int  # CTAs; each group of lanes walks rows grid-stride


def layer_norm_plan(rows: int, c: int) -> LayerNormPlan:
    """Lanes per row: the largest power of two up to 32 that splits the
    row's c/8 vectors evenly into at most ``MAX_VPT`` per lane (else 32
    lanes, the last ones idle on part of the row). CTAs of up to 128
    threads, halved while the grid would have fewer CTAs than SMs (down to
    one row group per CTA), and at most 4 CTAs per SM: beyond that the
    groups loop over rows."""
    nvec = c // 8
    lanes = 32
    while lanes > 1 and (nvec % lanes or nvec // lanes > MAX_VPT):
        lanes //= 2
    if nvec % lanes or nvec // lanes > MAX_VPT:
        lanes = 32
    vpt = -(-nvec // lanes)
    per_cta = max(1, 128 // lanes)  # row groups per CTA
    while per_cta > 1 and -(-rows // per_cta) < SMS:
        per_cta //= 2
    return LayerNormPlan(lanes, vpt, per_cta * lanes, min(-(-rows // per_cta), 4 * SMS))


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, cast back to ``x``'s dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                     eps: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain K5, as ``pww_tpu/ops/layer_norm.py:_reference_layer_norm``
    (flax ``LayerNorm``) computes it."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(out_dtype or x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K5: LayerNorm over the last dim of ``x`` (..., C); ``weight`` and
    ``bias`` (C,) f32 or bf16; the result has ``out_dtype`` (default x's
    dtype; the kernel writes bf16 or f32)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps=eps, out_dtype=out_dtype)
    cuda_build.refuse_grad("layer_norm", x, weight, bias)
    c = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"layer_norm: the CUDA kernel takes contiguous bf16 on the "
                         f"card, got {x.dtype} on {x.device}")
    if c % 8 or c > MAX_WIDTH or x.data_ptr() % 16:
        raise ValueError(f"layer_norm: the kernel takes a last dim that is a multiple "
                         f"of 8 and at most {MAX_WIDTH}, 16-byte aligned; got {c}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_norm: the kernel writes bf16 or f32, not {out_dtype}")
    w, b = weight.contiguous(), bias.contiguous().to(weight.dtype)
    if (w.shape != (c,) or b.shape != (c,) or w.device != x.device
            or w.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"layer_norm: weight and bias must be ({c},) f32 or bf16 "
                         f"on {x.device}")
    w, b = (p if p.data_ptr() % 16 == 0 else p.clone() for p in (w, b))  # vector loads
    rows = x.numel() // c
    plan = layer_norm_plan(rows, c)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = cuda_build.function("layer_norm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, c,
             eps, int(w.dtype == torch.bfloat16), int(out_dtype == torch.float32),
             plan.lanes.bit_length() - 1, plan.vpt, plan.threads, plan.grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


def layer_norm_site(ln: nn.LayerNorm, x: torch.Tensor, *, fused: bool) -> torch.Tensor:
    """A model's LayerNorm site. K5 (on a contiguous copy of x if it is not
    contiguous) runs where x is bf16 on the card, autograd records no
    gradient through x or the affine (:func:`~pww_tpu_torch.ops.cuda_build.
    norm_site_takes_kernel`), and the last dim is a multiple of 8 of at
    most ``MAX_WIDTH`` on a 16-byte boundary, and on every device when
    ``fused`` (the config's knob; the plain K5 on the CPU). Everything else
    runs :func:`layer_norm_f32`; a width the kernel refuses falls back."""
    if not fused and cuda_build.norm_site_takes_kernel(x, ln.weight, ln.bias):
        x = x.contiguous()
        fused = x.shape[-1] % 8 == 0 and x.shape[-1] <= MAX_WIDTH and x.data_ptr() % 16 == 0
    if fused:
        return layer_norm(x.contiguous(), ln.weight, ln.bias, eps=ln.eps)
    return layer_norm_f32(ln, x)
