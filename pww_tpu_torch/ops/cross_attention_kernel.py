"""K1 and K2: the paint-with-words cross-attention kernels and their plain versions.

Port of :mod:`pww_tpu.ops.cross_attention_kernel`. At every cross-attention
site with a PwW bias and Lq at or above the dispatch threshold the UNet
runs, per sample b,

  * K1 :func:`fused_pww_reduce`: ``r[b] = reduce(QKᵀ)`` over (H, Lq, Lk)
    (``csrc/pww_reduce.cu``), then ``coef = sigma_coef(σ) · r`` on the
    device, then
  * K2 :func:`fused_pww_cross_attention`:
    ``softmax((QKᵀ + coef[b]·w[b]) · dh^-½) · V`` (``csrc/pww_cross_attention.cu``).

The global reduce must finish before the bias is applied, so they stay two
launches. Each wrapper takes its plain PyTorch version for tensors on the
CPU and launches its CUDA kernel for tensors on the card (bf16, contiguous);
anything else raises. Each counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .weight_functions import AnyWeightFunction

_MODES = {"max": 0, "mean": 1, "std": 2}
HEAD_DIMS = (40, 64, 80, 160)  # K2 and K3: instantiated in csrc/{pww_cross,flash}_attention.cu
_P, _I = ctypes.c_void_p, ctypes.c_int


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    """The CUDA kernels take contiguous bf16 (B, H, L, dh) tensors on one
    card, with an even dh."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
        if t.dim() != 4 or t.shape[-1] % 2:
            raise ValueError(f"{name}: expected (B, H, L, dh) with even dh, got {tuple(t.shape)}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _reduce_rows_per_cta() -> int:
    """Query rows per K1 partial, a constant of ``csrc/pww_reduce.cu``."""
    return cuda_build.function("pww_reduce_rows_per_cta", [])()


def pww_cross_attention_reduce(q: torch.Tensor, k: torch.Tensor,
                               weight_fn: AnyWeightFunction) -> torch.Tensor:
    """Plain K1: per-sample ``reduce(QKᵀ)`` over a materialized f32 score
    tensor. Returns (B,) f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return weight_fn.reduce_qk(s, batch_axes=1).reshape(q.shape[0])


def fused_pww_reduce(q: torch.Tensor, k: torch.Tensor,
                     weight_fn: AnyWeightFunction) -> torch.Tensor:
    """K1: per-sample ``reduce(QKᵀ)`` over (H, Lq, Lk); (B,) f32.

    ``max``/``mean``/``std`` (unbiased) as :meth:`WeightFunction.reduce_qk`;
    mode ``one`` returns ones without a launch.
    """
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    mode = weight_fn.reduce_mode
    if mode == "one":
        return torch.ones((b,), dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return pww_cross_attention_reduce(q, k, weight_fn)
    check_kernel_inputs("fused_pww_reduce", q, k)
    if k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"fused_pww_reduce: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    nq = -(-lq // _reduce_rows_per_cta())
    part = torch.empty((b * h * nq, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b,), dtype=torch.float32, device=q.device)
    fn = cuda_build.function("pww_reduce", [_P] * 4 + [_I] * 6 + [_P])
    err = fn(q.data_ptr(), k.data_ptr(), part.data_ptr(), out.data_ptr(), b, h,
             lq, lk, dh, _MODES[mode], _stream(q))
    cuda_build.check(err, "fused_pww_reduce")
    fused_pww_reduce.launches += 1
    return out


fused_pww_reduce.launches = 0


def pww_cross_attention_plain(q, k, v, w, coef) -> torch.Tensor:
    """Plain K2: ``softmax((QKᵀ + coef[b]·w[b])·dh^-½)·V`` in f32, cast to
    V's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = (s + coef.float()[:, None, None, None] * w.float()[:, None]) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(v.dtype)


def fused_pww_cross_attention(
    q: torch.Tensor,  # (B, H, Lq, dh)
    k: torch.Tensor,  # (B, H, Lk, dh)
    v: torch.Tensor,  # (B, H, Lk, dh)
    w: torch.Tensor,  # (B, Lq, Lk) token-region weights (zero rows = no bias)
    coef: torch.Tensor,  # (B,) f32: sigma_coef * reduce(QKᵀ) per sample
) -> torch.Tensor:
    """K2: fused PwW cross-attention. Returns (B, H, Lq, dh) in V's dtype."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if q.device.type == "cpu":
        return pww_cross_attention_plain(q, k, v, w, coef)
    check_kernel_inputs("fused_pww_cross_attention", q, k, v)
    if k.shape != (b, h, lk, dh) or v.shape != k.shape:
        raise ValueError("fused_pww_cross_attention: k and v must be (B, H, Lk, dh)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"fused_pww_cross_attention: head dim {dh} not in {HEAD_DIMS}")
    if (w.shape != (b, lq, lk) or w.dtype != torch.float32
            or not w.is_contiguous() or w.device != q.device):
        raise ValueError(f"fused_pww_cross_attention: w must be contiguous f32 "
                         f"({b}, {lq}, {lk}) on {q.device}")
    if coef.shape != (b,) or coef.dtype != torch.float32 or coef.device != q.device:
        raise ValueError(f"fused_pww_cross_attention: coef must be f32 ({b},) on {q.device}")
    coef = coef.contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function("pww_cross_attention",
                             [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             coef.data_ptr(), out.data_ptr(), b, h, lq, lk, dh, dh ** -0.5, _stream(q))
    cuda_build.check(err, "fused_pww_cross_attention")
    fused_pww_cross_attention.launches += 1
    return out


fused_pww_cross_attention.launches = 0
