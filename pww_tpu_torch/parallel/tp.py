"""The tensor-parallel group as the UNet's sharded modules use it.

:func:`pww_tpu_torch.parallel.mesh.shard_params` hands each cut attention
and feed-forward a :class:`TensorParallel`; the modules call its
collectives and :func:`row_parallel`. Kept apart from :mod:`.mesh`, so
that the models import it and not the mesh's rules.

Under autograd the collectives are Megatron's two operators: the sum of a
row-parallel output (``to_out``, ``ff.net.2``) is an all-reduce forward and
the identity backward (:meth:`TensorParallel.all_sum`), and the replicated
input of a layer cut by output columns (the hidden and text states into
``to_q``/``to_k``/``to_v``, GEGLU's ``proj`` input, the IP branch's tokens)
is the identity forward and an all-reduce of its gradient backward
(:meth:`TensorParallel.enter`). Under ``torch.no_grad()`` or inference mode
they issue what they issued before: one in-place sum, and nothing.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

# Collectives issued by the sharded modules in this process, by kind: over tp
# "sum" (to_out / ff.net.2), "reduce" (a weight function's reduction),
# "gather" (heads for a custom weight function or SAG), "grad_sum" (an
# input's gradient, backward); over the dp rows of a spatial call
# (parallel.spatial) "halo", "norm", "kv", "r" and "rows"
COLLECTIVES: collections.Counter = collections.Counter()


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a collective without an autograd formula would take a
    tensor that requires a gradient: the gradient would be dropped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward over the mesh: the training paths never need it "
            "(no PwW bias, no SAG, no custom weight function), so it cannot run under "
            "autograd on tensors that require a gradient")


class _SumForward(torch.autograd.Function):
    """An all-reduce sum forward, the identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, an all-reduce sum of the gradient backward
    (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        COLLECTIVES["grad_sum"] += 1
        return dy, None


def combine(mode: str, r: torch.Tensor, n_local: int, local_mean: Callable[[], torch.Tensor],
            group, size: int) -> torch.Tensor:
    """A weight function's per-sample reduction (B,) f32 over the elements
    of ``size`` ranks from each rank's ``r`` over its ``n_local`` of them;
    ``local_mean()`` is this rank's mean (``std`` only). ``max``: the max
    over ranks; ``mean``: the sum of the local means / size; ``std``
    (unbiased): Chan's combination of each rank's (mean, M2), gathered and
    summed in rank order, so that every rank computes the same value."""
    if mode == "max":
        dist.all_reduce(r, op=dist.ReduceOp.MAX, group=group)
        return r
    if mode == "mean":
        r = r / size
        dist.all_reduce(r, group=group)
        return r
    mine = torch.stack([local_mean().float(), r * r * (n_local - 1)])  # (2, B)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine, group=group)
    parts = torch.stack(parts)  # (size, 2, B)
    mean = parts[:, 0].sum(0) / size
    m2 = parts[:, 1].sum(0) + n_local * ((parts[:, 0] - mean) ** 2).sum(0)
    return torch.sqrt(m2 / max(size * n_local - 1, 1))


class TensorParallel:
    """The ``"tp"`` group as a sharded module uses it: this rank's index,
    the group's size, and the collectives."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over tp, in ``x``'s dtype: in place, or under autograd
        an all-reduce whose backward is the identity."""
        COLLECTIVES["sum"] += 1
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumForward.apply(x, self.group)
        dist.all_reduce(x, group=self.group)
        return x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the replicated input of a layer cut by output columns:
        itself, whose gradient is summed over tp under autograd."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumBackward.apply(x, self.group)
        return x

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H/tp, ...) on every rank → (B, H, ...), heads in rank order."""
        refuse_grad("gather_heads (a custom weight function or SAG on a tp cut)", x)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        COLLECTIVES["gather"] += 1
        return torch.cat(parts, dim=1)

    def local_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, ...) → this rank's (B, H/tp, ...)."""
        k = x.shape[1] // self.size
        return x[:, self.rank * k:(self.rank + 1) * k]

    def combine_reduce(self, mode: str, r: torch.Tensor, n_local: int,
                       local_mean: Callable[[], torch.Tensor]) -> torch.Tensor:
        """:func:`combine` over tp: each rank reduced its (H/tp, Lq, Lk)."""
        if mode == "one":
            return r
        refuse_grad("combine_reduce (a PwW weight function's reduction on a tp cut)", r)
        COLLECTIVES["reduce"] += 1
        return combine(mode, r, n_local, local_mean, self.group, self.size)


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor,
                 tp: Optional[TensorParallel]) -> torch.Tensor:
    """``linear(x)`` for a Linear cut by input columns: this rank's partial
    product, summed over tp, then the bias once."""
    if tp is None:
        return linear(x)
    y = tp.all_sum(F.linear(x, linear.weight))
    return y if linear.bias is None else y + linear.bias
