"""K3: flash self-attention for the UNet's high-resolution self-attention sites.

Port of :mod:`pww_tpu.ops.flash_attention`. The wrapper takes its plain
PyTorch version for tensors on the CPU and launches the CUDA kernel
(``csrc/flash_attention.cu``: online softmax, tensor-core products, no
(L × L) scores in device memory) for bf16 tensors on the card; anything else
raises. Launches are counted in ``flash_self_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cross_attention_kernel import HEAD_DIMS, check_kernel_inputs


def self_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``softmax(QKᵀ·dh^-½)·V`` with f32 scores, cast to V's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(v.dtype)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Self-attention, (B, H, L, dh) → (B, H, L, dh). No bias, no mask."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    check_kernel_inputs("flash_self_attention", q, k, v)
    b, h, l, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_self_attention: q, k, v must share one shape")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_self_attention: head dim {dh} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "flash_self_attention",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, l,
             dh, dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_self_attention")
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0
