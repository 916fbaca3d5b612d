"""K1 and K2: the paint-with-words cross-attention kernels and their plain versions.

Port of :mod:`pww_tpu.ops.cross_attention_kernel`. At every cross-attention
site with a PwW bias and Lq at or above the dispatch threshold the UNet
runs, per sample b,

  * K1 :func:`fused_pww_reduce`: ``r[b] = reduce(QKᵀ)`` over (H, Lq, Lk)
    (``csrc/pww_reduce.cu``: one launch, laid out by
    :func:`pww_reduce_plan`), then ``coef = sigma_coef(σ) · r`` on the
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
from typing import NamedTuple

import torch

from . import cuda_build
from .group_norm import SMEM_PER_CTA, SMS
from .weight_functions import AnyWeightFunction

_MODES = {"max": 0, "mean": 1, "std": 2}
HEAD_DIMS = (40, 64, 80, 160)  # K1-K3: instantiated in their csrc/*.cu
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


# csrc/pww_reduce.cu: keys per chunk, the most Q tiles in a warp's ring,
# bytes of the CTA's tail (the warps' moments and the last-CTA flag)
_KEYS, _STAGES, _TAIL_BYTES = 80, 8, 144
# Warps per CTA where the grid has room for them (at most 8); Q tiles per
# warp double while the grid keeps this many CTAs per SM (7/8 of that many
# waves): fewer CTAs stage K fewer times.
WARPS = 8
CTAS_PER_SM = 2


class ReducePlan(NamedTuple):
    """How ``csrc/pww_reduce.cu`` covers (B·H, Lq, Lk).

    CTA i = (bh · row_splits + rs) · key_splits + ks takes query rows
    [rs·R, rs·R + R), R = 16·warps·tiles (warp w the 16-row tiles
    [w·tiles, (w + 1)·tiles) of them), and keys [ks·80·key_chunks,
    (ks + 1)·80·key_chunks) of head bh, and writes one partial.
    """

    warps: int  # per CTA, 1, 2, 4 or 8
    tiles: int  # 16-row Q tiles per warp
    key_chunks: int  # 80-key chunks of K in a CTA's shared memory
    row_splits: int  # CTAs per head along Lq
    key_splits: int  # CTAs per head and row run along Lk
    ctas: int  # the grid, and the partials: B·H·row_splits·key_splits
    smem_bytes: int  # dynamic shared memory per CTA

    @property
    def rows(self) -> int:
        """Query rows per CTA."""
        return 16 * self.warps * self.tiles


def _reduce_smem_bytes(dh: int, warps: int, tiles: int, key_chunks: int) -> int:
    """``csrc/pww_reduce.cu:smem_bytes``: K chunks and each warp's Q ring
    (a stage per tile, at most ``_STAGES``), bf16 rows of dh padded to 16
    plus 8, and the tail."""
    ld = -(-dh // 16) * 16 + 8
    return 2 * ld * (key_chunks * _KEYS + warps * min(tiles, _STAGES) * 16) + _TAIL_BYTES


@functools.cache
def pww_reduce_plan(b: int, h: int, lq: int, lk: int, dh: int) -> ReducePlan:
    """The launch plan of K1 for q (b, h, lq, dh) and k (b, h, lk, dh).

    Each CTA keeps all of K (or as many 80-key chunks as fit beside the Q
    rings) in shared memory. Warps per CTA: ``WARPS``, or fewer where they
    leave the grid short of 7/8 of a wave of the H100's SMS SMs (Lq 256 at
    dh 160 has only 256 tiles of 16 rows) or where their Q rings leave K
    less room, so that Q is read as few times as the card allows. Then
    each warp's Q tiles double while the grid keeps 7/8 of ``CTAS_PER_SM``
    waves, so that fewer CTAs copy K.
    """
    if dh not in HEAD_DIMS:
        raise ValueError(f"fused_pww_reduce: head dim {dh} not in {HEAD_DIMS}")
    chunks = -(-lk // _KEYS)

    def layout(warps, tiles):  # None where not one chunk fits beside the rings
        room = SMEM_PER_CTA - _reduce_smem_bytes(dh, warps, tiles, 0)
        kc = min(chunks, room // (_reduce_smem_bytes(dh, 0, 0, 1) - _TAIL_BYTES))
        if kc < 1:
            return None
        ks = -(-chunks // kc)
        kc = -(-chunks // ks)  # the same number of chunks in every split
        rs = -(-lq // (16 * warps * tiles))
        return ReducePlan(warps, tiles, kc, rs, ks, b * h * rs * ks,
                          _reduce_smem_bytes(dh, warps, tiles, kc))

    fewest_key_splits = layout(1, 1).key_splits
    for warps in [w for w in (8, 4, 2, 1) if w <= WARPS]:
        plan = layout(warps, 1)
        if (plan is not None and 8 * plan.ctas >= 7 * SMS
                and plan.key_splits == fewest_key_splits):
            break
    while True:
        wider = layout(plan.warps, 2 * plan.tiles)
        if (wider is None or wider.key_splits > plan.key_splits
                or wider.row_splits == plan.row_splits
                or 8 * wider.ctas < 7 * SMS * CTAS_PER_SM):
            return plan
        plan = wider


@functools.cache
def _ticket_counter(device_index: int, stream: int) -> torch.Tensor:
    """K1's ticket counter for this card and stream, zeroed once; every
    launch leaves it at 0. Two streams never share one."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", device_index))


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
    plan = pww_reduce_plan(b, h, lq, lk, dh)
    stream = _stream(q)
    part = torch.empty((plan.ctas, 4), dtype=torch.float32, device=q.device)
    out = torch.empty((b,), dtype=torch.float32, device=q.device)
    fn = cuda_build.function("pww_reduce", [_P] * 5 + [_I] * 12 + [_P])
    err = fn(q.data_ptr(), k.data_ptr(), part.data_ptr(),
             _ticket_counter(q.device.index, stream).data_ptr(), out.data_ptr(), b, h, lq, lk,
             dh, _MODES[mode], plan.warps, plan.tiles, plan.key_chunks, plan.row_splits,
             plan.key_splits, plan.smem_bytes, stream)
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
