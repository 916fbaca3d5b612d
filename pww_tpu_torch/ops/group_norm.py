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
tensors on the CPU and launches the CUDA kernel (``csrc/group_norm.cu``: one
launch, a thread-block cluster per group span, read once into shared memory
wherever the span fits; :func:`group_norm_plan` sizes it) for contiguous
bf16 tensors on the card; anything else raises, inputs that require a
gradient under grad mode among them (the kernel has no backward). Launches
are counted in ``group_norm.launches``.

:func:`group_norm_site` is a model's GroupNorm site. It runs K4 where
:func:`~pww_tpu_torch.ops.cuda_build.norm_site_takes_kernel` holds (bf16 on
the card, no gradient recorded through it), and everywhere when the
config's ``fused_group_norm`` knob is on (the plain K4 on the CPU).
Everything else, the CPU, f32 pipelines and training among it, runs
:func:`group_norm_f32`, the unfused composition (``F.group_norm`` in f32,
another variance formula).

The split form, for a site whose rows are cut over the ranks of a spatially
sharded call (:mod:`pww_tpu_torch.parallel.spatial`): :func:`group_norm_stats`
writes this rank's f32 (mean, M2) per (sample, group), the ranks' pairs are
combined (Chan's rule), and :func:`group_norm_apply` normalizes with the
given (mean, rstd). Both are CUDA kernels on the card (``csrc/group_norm.cu``:
``group_norm_stats``, ``group_norm_apply``), each with its plain version and
its ``.launches``; :func:`group_norm_site` takes that route by itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
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


SMEM_PER_CTA = 232_448  # the H100's shared memory a CTA may opt in to
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMS = 132  # the H100 SXM's SMs
# A cluster grows past the smallest that holds the span while the grid stays
# within 4 CTAs per SM and the pieces at least this many elements (8 KB).
MIN_PIECE = 4096


class GroupNormPlan(NamedTuple):
    """How ``csrc/group_norm.cu`` covers one (sample, group) span."""

    cluster: int  # CTAs per (sample, group)
    piece: int  # elements of the span per CTA, a multiple of 8
    resident: int  # of them, in shared memory: all of the piece, or none
    smem_bytes: int  # dynamic shared memory per CTA
    threads: int  # per CTA: 512 where one CTA fills an SM's shared memory, else 256

    @property
    def streamed(self) -> bool:
        return self.resident < self.piece


def _smem_bytes(resident: int, cpg: int) -> int:
    """The kernel's shared memory: the resident elements, add/w/b per
    channel of the group in f32, and 320 bytes of mbarriers and sums
    (``csrc/group_norm.cu:smem_bytes``)."""
    return -(-2 * resident // 16) * 16 + -(-12 * cpg // 16) * 16 + 320


def _plan(cluster: int, piece: int, resident: int, cpg: int) -> GroupNormPlan:
    smem = _smem_bytes(resident, cpg)
    return GroupNormPlan(cluster, piece, resident, smem, 512 if 2 * smem > SMEM_PER_CTA else 256)


def group_norm_plan(span: int, cpg: int, spans: int, max_cluster: int = 16) -> GroupNormPlan:
    """The launch plan for ``spans`` (N·G) group spans of ``span`` elements
    over ``cpg`` channels each.

    Resident when some cluster of at most ``max_cluster`` CTAs holds the span
    in shared memory: the smallest that does, doubled while the grid stays
    within 4 CTAs per SM and the pieces at least ``MIN_PIECE``. Otherwise
    streamed: ``max_cluster`` CTAs read their pieces twice, with nothing
    resident, so that many CTAs share an SM and its memory and arithmetic
    overlap (faster on the H100 than holding 226 KB of each piece, which
    leaves one CTA per SM).
    """
    def piece(n):  # ceil(span / n), rounded up to 8 elements (16 bytes)
        return ((span + n - 1) // n + 7) // 8 * 8

    fits = [n for n in CLUSTER_SIZES
            if n <= max_cluster and _smem_bytes(piece(n), cpg) <= SMEM_PER_CTA]
    if fits:
        n = fits[0]
        while n < max_cluster and spans * 2 * n <= 4 * SMS and piece(2 * n) >= MIN_PIECE:
            n *= 2
        return _plan(n, piece(n), piece(n), cpg)
    return _plan(max_cluster, piece(max_cluster), 0, cpg)


@functools.cache
def _max_cluster(device_index: int) -> int:
    """The largest cluster the card places with full shared memory per CTA."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        cuda_build.check(cuda_build.function("group_norm_max_cluster", [_P])(ctypes.byref(n)),
                         "group_norm_max_cluster")
    return n.value


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
    cuda_build.refuse_grad("group_norm", x, weight, bias, add)
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"group_norm: the CUDA kernel takes contiguous bf16 NCHW on "
                         f"the card, got {x.dtype} on {x.device}")
    if x.dim() < 3 or c % groups or x.numel() == 0:
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
    cpg = c // groups
    plan = group_norm_plan(cpg * hw, cpg, n * groups, _max_cluster(x.device.index or 0))
    out = _launch(x, *params, add, groups=groups, eps=eps, silu=silu, out_dtype=out_dtype,
                  plan=plan)
    group_norm.launches += 1
    return out


def _launch(x, weight, bias, add, *, groups, eps, silu, out_dtype, plan) -> torch.Tensor:
    """One launch of ``csrc/group_norm.cu`` on checked inputs with ``plan``."""
    n, c = x.shape[:2]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = cuda_build.function("group_norm", [_P] * 5 + [_I] * 8 + [ctypes.c_float]
                             + [_I] * 3 + [_P])
    err = fn(x.data_ptr(), 0 if add is None else add.data_ptr(), weight.data_ptr(),
             bias.data_ptr(), out.data_ptr(), n, c, x[0, 0].numel(), groups, plan.cluster,
             plan.piece, plan.resident, plan.threads, eps, int(silu),
             int(weight.dtype == torch.bfloat16),
             int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "group_norm")
    return out


group_norm.launches = 0


def group_norm_stats_plain(x: torch.Tensor, *, groups: int,
                           add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain split K4 statistics: (N, G, 2) f32, each (sample, group)'s mean
    and M2 = count · max(E[v²] − mean², 0) over ``x + add`` (in x's dtype)."""
    n, c = x.shape[:2]
    xf = _with_add(x, add).float().reshape(n, groups, -1)
    mean = xf.mean(-1)
    var = torch.clamp((xf * xf).mean(-1) - mean * mean, min=0.0)
    return torch.stack([mean, var * xf.shape[-1]], dim=-1)


def group_norm_apply_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           stats: torch.Tensor, *, groups: int, silu: bool = False,
                           add: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain split K4 normalization with ``stats`` (N, G, 2) f32 (mean,
    rstd): ``(v − mean)·rstd·w + b`` (then SiLU) in f32, cast."""
    n, c = x.shape[:2]
    xf = _with_add(x, add).float().reshape(n, groups, c // groups, -1)
    mean, rstd = stats[..., 0, None, None], stats[..., 1, None, None]
    mul = rstd * weight.float().reshape(1, groups, -1, 1)
    y = (xf - mean) * mul + bias.float().reshape(1, groups, -1, 1)
    if silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(out_dtype or x.dtype)


STATS_MAX_CLUSTER = 8  # the portable cluster size: no opt-in attribute


def group_norm_stats_plan(span: int, spans: int) -> Tuple[int, int]:
    """(cluster, piece) of ``csrc/group_norm.cu:gn_stats`` for ``spans``
    (N·G) spans of ``span`` elements: the cluster doubles from 1 while the
    grid stays within 4 CTAs per SM and the pieces at least ``MIN_PIECE``."""
    def piece(n):
        return ((span + n - 1) // n + 7) // 8 * 8

    n = 1
    while n < STATS_MAX_CLUSTER and spans * 2 * n <= 4 * SMS and piece(2 * n) >= MIN_PIECE:
        n *= 2
    return n, piece(n)


def _split_inputs(what, x, add):
    cuda_build.refuse_grad(what, x, add)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes contiguous bf16 NCHW on the card, "
                         f"got {x.dtype} on {x.device}")
    n, c = x.shape[:2]
    if add is not None:
        if add.shape != (n, c) or add.device != x.device:
            raise ValueError(f"{what}: add must be ({n}, {c}) on {x.device}")
        add = add.to(torch.bfloat16).contiguous()
    return add


def group_norm_stats(x: torch.Tensor, *, groups: int,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split K4, statistics: :func:`group_norm_stats_plain` on the CPU, one
    launch of ``csrc/group_norm.cu:group_norm_stats`` on the card."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, groups=groups, add=add)
    add = _split_inputs("group_norm_stats", x, add)
    n, c = x.shape[:2]
    if x.dim() < 3 or c % groups or x.numel() == 0:
        raise ValueError(f"group_norm_stats: {tuple(x.shape)} with {groups} groups")
    hw = x[0, 0].numel()
    cluster, piece = group_norm_stats_plan(c // groups * hw, n * groups)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    fn = cuda_build.function("group_norm_stats", [_P] * 3 + [_I] * 6 + [_P])
    cuda_build.check(fn(x.data_ptr(), 0 if add is None else add.data_ptr(), stats.data_ptr(),
                        n, c, hw, groups, cluster, piece,
                        torch.cuda.current_stream(x.device).cuda_stream), "group_norm_stats")
    group_norm_stats.launches += 1
    return stats


def group_norm_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     stats: torch.Tensor, *, groups: int, silu: bool = False,
                     add: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Split K4, normalization with ``stats`` (N, G, 2) f32 (mean, rstd):
    :func:`group_norm_apply_plain` on the CPU, one launch of
    ``csrc/group_norm.cu:group_norm_apply`` on the card."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, weight, bias, stats, groups=groups, silu=silu,
                                      add=add, out_dtype=out_dtype)
    cuda_build.refuse_grad("group_norm_apply", weight, bias)
    add = _split_inputs("group_norm_apply", x, add)
    n, c = x.shape[:2]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_apply: the kernel writes bf16 or f32, not {out_dtype}")
    if stats.shape != (n, groups, 2) or stats.dtype != torch.float32 or c % groups:
        raise ValueError(f"group_norm_apply: stats must be ({n}, {groups}, 2) f32")
    params = [p.contiguous() for p in (weight, bias)]
    if params[0].dtype not in (torch.float32, torch.bfloat16) or params[0].shape != (c,):
        raise ValueError(f"group_norm_apply: weight and bias must be ({c},) f32 or bf16")
    params[1] = params[1].to(params[0].dtype)
    stats = stats.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = cuda_build.function("group_norm_apply", [_P] * 6 + [_I] * 7 + [_P])
    cuda_build.check(fn(x.data_ptr(), 0 if add is None else add.data_ptr(),
                        params[0].data_ptr(), params[1].data_ptr(), stats.data_ptr(),
                        out.data_ptr(), n, c, x[0, 0].numel(), groups, int(silu),
                        int(params[0].dtype == torch.bfloat16),
                        int(out_dtype == torch.float32),
                        torch.cuda.current_stream(x.device).cuda_stream), "group_norm_apply")
    group_norm_apply.launches += 1
    return out


group_norm_stats.launches = 0
group_norm_apply.launches = 0


def _spatial_group_norm(sp, gn: nn.GroupNorm, x: torch.Tensor, fused: bool, silu: bool,
                        add: Optional[torch.Tensor]) -> torch.Tensor:
    """A GroupNorm site over this rank's rows: the rank's moments, combined
    over the dp group (:meth:`~pww_tpu_torch.parallel.spatial.Spatial.
    combine_moments`), then the affine. Where :func:`group_norm_site` picks
    K4 (``fused``), split K4 (the statistics kernel, the combine, the apply
    kernel); else f32 PyTorch."""
    n, c = x.shape[:2]
    g = gn.num_groups
    count = c // g * x[0, 0].numel()
    if fused:
        x = x.contiguous()
        st = group_norm_stats(x, groups=g, add=add)
        mean, m2 = st[..., 0], st[..., 1]
    else:
        x = _with_add(x, add)
        add = None
        xf = x.float().reshape(n, g, -1)
        mean = xf.mean(-1)
        m2 = ((xf - mean[..., None]) ** 2).sum(-1)
    mean, var = sp.combine_moments(mean, m2, count)
    stats = torch.stack([mean, torch.rsqrt(torch.clamp(var, min=0.0) + gn.eps)], dim=-1)
    if fused:
        return group_norm_apply(x, gn.weight, gn.bias, stats, groups=g, silu=silu, add=add)
    return group_norm_apply_plain(x, gn.weight, gn.bias, stats, groups=g, silu=silu)


def group_norm_site(gn: nn.GroupNorm, x: torch.Tensor, *, fused: bool,
                    silu: bool = False, add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A model's GroupNorm site, with the pre-add and SiLU fused where K4
    runs it. K4 (on a contiguous copy of x if it is not contiguous) runs
    where x is bf16 on the card and autograd records no gradient through
    x, the affine or ``add`` (:func:`~pww_tpu_torch.ops.cuda_build.
    norm_site_takes_kernel`), and on every device when ``fused`` (the
    config's knob; the plain K4 on the CPU). Everything else runs the
    pre-add in x's dtype followed by :func:`group_norm_f32`. The result has
    x's dtype. Over a rank's rows of a spatially sharded call, the same
    rule picks split K4 or the f32 moments, and the statistics are the
    whole image's (:func:`_spatial_group_norm`)."""
    fused = fused or cuda_build.norm_site_takes_kernel(x, gn.weight, gn.bias, add)
    sp = spatial.site(x)
    if sp is not None:
        return _spatial_group_norm(sp, gn, x, fused, silu, add)
    if fused:
        return group_norm(x.contiguous(), gn.weight, gn.bias, groups=gn.num_groups, eps=gn.eps,
                          silu=silu, add=add)
    return group_norm_f32(gn, _with_add(x, add), silu=silu)
