"""The tensor-parallel group as the UNet's sharded modules use it.

:func:`pww_tpu_torch.parallel.mesh.shard_params` hands each cut attention
and feed-forward a :class:`TensorParallel`; the modules call its
collectives and :func:`row_parallel`. Kept apart from :mod:`.mesh`, so
that the models import it and not the mesh's rules.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

# Collectives issued by the tensor-parallel modules in this process, by kind:
# "sum" (to_out / ff.net.2), "reduce" (a weight function's reduction),
# "gather" (heads for a custom weight function or SAG)
COLLECTIVES: collections.Counter = collections.Counter()


class TensorParallel:
    """The ``"tp"`` group as a sharded module uses it: this rank's index,
    the group's size, and the collectives."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """In place, in ``x``'s dtype."""
        dist.all_reduce(x, group=self.group)
        COLLECTIVES["sum"] += 1
        return x

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H/tp, ...) on every rank → (B, H, ...), heads in rank order."""
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
        """A weight function's per-sample reduction over (H, Lq, Lk) from
        each rank's over its (H/tp, Lq, Lk): ``r`` (B,) f32 is this rank's;
        ``n_local`` the elements it reduced per sample; ``local_mean()``
        this rank's mean (``std`` only). ``max``: the max over ranks;
        ``mean``: the sum of the local means / tp; ``std`` (unbiased):
        Chan's combination of each rank's (mean, M2), gathered and summed
        in rank order, so that every rank computes the same value."""
        if mode == "one":
            return r
        COLLECTIVES["reduce"] += 1
        if mode == "max":
            dist.all_reduce(r, op=dist.ReduceOp.MAX, group=self.group)
            return r
        if mode == "mean":
            r = r / self.size
            dist.all_reduce(r, group=self.group)
            return r
        mine = torch.stack([local_mean().float(), r * r * (n_local - 1)])  # (2, B)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        parts = torch.stack(parts)  # (tp, 2, B)
        mean = parts[:, 0].sum(0) / self.size
        m2 = parts[:, 1].sum(0) + n_local * ((parts[:, 0] - mean) ** 2).sum(0)
        return torch.sqrt(m2 / max(self.size * n_local - 1, 1))


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor,
                 tp: Optional[TensorParallel]) -> torch.Tensor:
    """``linear(x)`` for a Linear cut by input columns: this rank's partial
    product, summed over tp, then the bias once."""
    if tp is None:
        return linear(x)
    y = tp.all_sum(F.linear(x, linear.weight))
    return y if linear.bias is None else y + linear.bias
