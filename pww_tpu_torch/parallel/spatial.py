"""Spatial sharding: the rows of one image over the mesh's dp axis.

Port of ``generate(sharding="spatial")`` (``pww_tpu/parallel/mesh.py:
116-126``, ``pww_tpu/pipeline/pipeline.py:1879-1890``). There one placement
puts the latents' height over dp and GSPMD inserts the rest. Here each
process holds its contiguous block of rows at every level of the UNet and
of the VAE decoder, and every site that reads across rows says so:

  * a 3×3 convolution takes one row from each neighbour rank (the first and
    last ranks pad with zeros, as the whole convolution does)
    (:func:`conv`); the UNet's stride-2 downsample only the row above
    (:func:`down_conv`);
  * a GroupNorm combines each rank's f32 (mean, M2) over the rows with
    Chan's rule in rank order (:meth:`Spatial.combine_moments`);
  * a self-attention's queries are the rank's rows, its keys and values
    gathered over dp in rank order (:meth:`Spatial.gather_tokens`);
  * a PwW weight function's per-sample reduction is combined over dp
    (:meth:`Spatial.combine_reduce`, the rule of
    :meth:`~pww_tpu_torch.parallel.tp.TensorParallel.combine_reduce`);
  * what needs the whole image (ToMe's matching, FreeU's filter, SAG's
    probabilities, a custom weight function, a ControlNet) runs on gathered
    rows, whole on every rank, and is cut again.

A level whose height dp does not divide runs whole on every rank, as JAX
falls back to replication; the level below it is then whole too. The
handle is active for a call through :func:`use`; the sites find it with
:func:`current`. It also speaks the pipeline's ``BatchRows`` protocol
(``rows``, ``cfg``, ``pww``, ``added``, ``hint``, ``gather``,
``whole_shape``, ``whole``, ``sites``): the text states, the PwW weights
and the added conditions stay whole, the latents and every noise are cut
by rows.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .tp import COLLECTIVES, combine, refuse_grad

DP_AXIS = "dp"
_STATE = threading.local()


def current() -> Optional["Spatial"]:
    """The spatial handle of the call running on this thread, or None."""
    return getattr(_STATE, "sp", None)


@contextlib.contextmanager
def use(sp: Optional["Spatial"]):
    """Make ``sp`` (None: no spatial cut) the handle of the sites run inside."""
    prev = current()
    _STATE.sp = sp
    try:
        yield
    finally:
        _STATE.sp = prev


def chan_moments(parts: torch.Tensor, count: int):
    """Chan's rule over ``parts`` (k, 2, …): k equal blocks' f32 (mean, M2),
    each over ``count`` elements → the union's (mean, biased variance); the
    blocks summed in their order."""
    k = parts.shape[0]
    mean = parts[:, 0].sum(0) / k
    m2 = parts[:, 1].sum(0) + count * ((parts[:, 0] - mean) ** 2).sum(0)
    return mean, m2 / (count * k)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return tree


class Spatial:
    """One spatially sharded call on ``mesh``: ``n`` samples of latents
    ``height`` × ``width``; this process is rank ``rank`` of the ``size``
    ranks of its dp group."""

    def __init__(self, mesh, n: int, height: int, width: int):
        self.mesh, self.n = mesh, n
        self.group = mesh.get_group(DP_AXIS)
        self.rank, self.size = mesh.get_local_rank(DP_AXIS), mesh.size(0)
        self.height, self.width = height, width

    # -- where a tensor stands -------------------------------------------------
    def site_height(self, w: int) -> int:
        """The whole height of an activation ``w`` wide (the UNet's levels
        and the decoder's keep the latents' aspect)."""
        return self.height * w // self.width

    def is_cut(self, x: torch.Tensor) -> bool:
        """Whether ``x`` (…, h, w) holds this rank's rows of its level."""
        return self.size > 1 and x.shape[-2] * self.size == self.site_height(x.shape[-1])

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """A whole (…, H, W) tensor → this rank's block of rows; itself where
        dp does not divide H."""
        h = x.shape[-2]
        if self.size == 1 or h % self.size:
            return x
        k = h // self.size
        return x[..., self.rank * k:(self.rank + 1) * k, :]

    def settle(self, x: torch.Tensor) -> torch.Tensor:
        """A whole activation at a level that dp divides → its rows."""
        if x.shape[-2] == self.site_height(x.shape[-1]):
            return self.rows(x)
        return x

    def _gather(self, x: torch.Tensor, kind: str):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        COLLECTIVES[kind] += 1
        return parts

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (…, h, w) → the whole (…, H, w), ranks in order;
        a whole tensor as it is."""
        if not self.is_cut(x):
            return x
        return torch.cat(self._gather(x, "rows"), dim=-2)

    # -- the pipeline's BatchRows protocol ----------------------------------------
    def cfg(self, x):
        return x

    def pww(self, pww):
        return pww

    def added(self, added_cond):
        return added_cond

    def hint(self, x):
        """A ControlNet hint: whole, the net runs whole (:meth:`whole`)."""
        return x

    def whole_shape(self, lat: torch.Tensor):
        """The shape of the whole draw whose rows ``lat`` holds."""
        return (lat.shape[0], lat.shape[1], self.site_height(lat.shape[-1]), lat.shape[-1])

    def whole(self, fn: Callable, *xs):
        """``fn`` on the gathered ``xs``, whole on every rank with no spatial
        site active; the rows of its outputs at levels dp divides cut again."""
        xs = [self.gather(x) for x in xs]
        with use(None):
            out = fn(*xs)
        return _map(self.settle, out)

    def sites(self):
        return use(self)

    # -- the sites -------------------------------------------------------------------
    def halo_conv(self, conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A 3×3, stride-1, padding-1 convolution of this rank's rows: the
        last row of the rank above and the first of the rank below join
        them (zeros past the image's edges)."""
        parts = self._gather(torch.cat([x[..., :1, :], x[..., -1:, :]], dim=-2), "halo")
        zero = torch.zeros_like(x[..., :1, :])
        above = parts[self.rank - 1][..., 1:, :] if self.rank > 0 else zero
        below = parts[self.rank + 1][..., :1, :] if self.rank < self.size - 1 else zero
        return F.conv2d(torch.cat([above, x, below], dim=-2), conv.weight, conv.bias,
                        padding=(0, 1))

    def down_conv(self, conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """The UNet's 3×3, stride-2, padding-1 downsample: output row i reads
        input rows 2i-1..2i+1, so a rank needs the row above its (even)
        block. Where dp does not divide the level below, it runs whole."""
        if self.site_height(x.shape[-1] // 2) % self.size:
            return conv(self.gather(x))
        parts = self._gather(x[..., -1:, :], "halo")
        above = parts[self.rank - 1] if self.rank > 0 else torch.zeros_like(parts[0])
        return F.conv2d(torch.cat([above, x], dim=-2), conv.weight, conv.bias, stride=2,
                        padding=(0, 1))

    def combine_moments(self, mean: torch.Tensor, m2: torch.Tensor, count: int):
        """Each rank's f32 (mean, M2) over its ``count`` elements of every
        (sample, group) → the whole image's (mean, biased variance): Chan's
        rule over the gathered pairs, summed in rank order, the same bits on
        every rank."""
        parts = self._gather(torch.stack([mean.float(), m2.float()]), "norm")
        return chan_moments(torch.stack(parts), count)

    def gather_tokens(self, *xs: torch.Tensor, dim: int, kind: str = "kv"):
        """Each of ``xs`` (this rank's tokens along ``dim``) → all of them,
        ranks in order, in one collective."""
        parts = self._gather(torch.stack(xs), kind)
        return torch.cat(parts, dim=dim + 1 if dim >= 0 else dim).unbind(0)

    def local_tokens(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole site's tokens along ``dim`` → this rank's block."""
        k = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * k, k)

    def combine_reduce(self, mode: str, r: torch.Tensor, n_local: int,
                       local_mean: Callable[[], torch.Tensor]) -> torch.Tensor:
        """A weight function's reduction over the rank's rows, combined over
        dp (:func:`~pww_tpu_torch.parallel.tp.combine`)."""
        if mode == "one":
            return r
        refuse_grad("a PwW reduction over a spatial cut", r)
        COLLECTIVES["r"] += 1
        return combine(mode, r, n_local, local_mean, self.group, self.size)


def site(x: torch.Tensor) -> Optional[Spatial]:
    """The active handle where ``x`` holds a rank's rows, else None."""
    sp = current()
    return sp if sp is not None and sp.is_cut(x) else None


def conv(module: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 3×3, stride-1, padding-1 convolution site."""
    sp = site(x)
    return module(x) if sp is None else sp.halo_conv(module, x)


def down_conv(module: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 3×3, stride-2, padding-1 downsample site."""
    sp = site(x)
    return module(x) if sp is None else sp.down_conv(module, x)


def settle(x: torch.Tensor) -> torch.Tensor:
    """An activation made whole (an upsample of a whole level) → its rows
    where its level is cut."""
    sp = current()
    return x if sp is None else sp.settle(x)


def whole_site(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of an activation that needs the whole image (FreeU's filter):
    on the gathered rows where ``x`` is cut."""
    sp = site(x)
    return fn(x) if sp is None else sp.whole(fn, x)
