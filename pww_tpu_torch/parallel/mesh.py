"""Device mesh and the data- and tensor-parallel rules, one process per rank.

Port of :mod:`pww_tpu.parallel.mesh`. The JAX package has one controller:
one process sees every chip, lays them out as a (dp, tp) ``Mesh`` and lets
GSPMD insert the collectives from the parameter placements. The port follows
the PyTorch idiom instead: one process per rank, each calling the same entry
point with the same arguments, and each returning the whole result, equal
to what the call without a mesh returns (the JAX call returns the gathered
array too).

  * **data parallel** (``dp``): each rank of a ``"dp"`` group takes its
    contiguous block of the samples (:func:`shard_batch`; every rank when
    dp does not divide them), and the results are gathered at the end
    (:func:`gather_batch`);
  * **tensor parallel** (``tp``): each rank of a ``"tp"`` group keeps
    ``heads / tp`` heads of every attention and ``1 / tp`` of every GEGLU
    feed-forward's inner width (:func:`shard_params`, :data:`_TP_RULES`);
    ``to_out`` and ``ff.net.2`` are summed over the group before their bias
    (:class:`TensorParallel`), in the activation dtype, as JAX's psum.

:func:`spawn` starts local ranks (the tests, ``chip_smoke.py`` and
:mod:`pww_tpu_torch.parallel.dryrun`); on a cluster, ``torchrun`` starts
them and :func:`init_multihost` reads its environment.
"""
from __future__ import annotations

import os
import pickle
import re
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .tp import COLLECTIVES, TensorParallel  # noqa: F401

DP_AXIS = "dp"
TP_AXIS = "tp"


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on CUDA devices by default and none is available; "
                           "pass the CPU explicitly (backend='gloo', device_type='cpu')")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "nccl") -> int:
    """Join this process to the job's process group; returns its rank.

    A thin wrapper over ``torch.distributed.init_process_group``: the
    arguments default to ``torchrun``'s environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), a ``coordinator_address``
    ``host:port`` is reached over TCP. ``backend="nccl"`` (the default)
    needs CUDA and raises without it; the CPU takes ``"gloo"``, named by
    the caller. Under NCCL each rank takes the card ``LOCAL_RANK`` (else
    its rank modulo the host's cards)."""
    if backend == "nccl":
        _require_cuda("init_multihost(backend='nccl')")
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return dist.get_rank()


def make_mesh(dp: Optional[int] = None, tp: int = 1, device_type: str = "cuda"):
    """A (dp, tp) ``DeviceMesh`` over the process group's ranks (rank =
    dp index · tp + tp index). Defaults: every rank on the dp axis. Needs
    :func:`init_multihost` (or :func:`spawn`) first; ``device_type="cuda"``
    raises without CUDA."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        _require_cuda("make_mesh(device_type='cuda')")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_multihost() (or run "
                           "under parallel.mesh.spawn) first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=(DP_AXIS, TP_AXIS))


# ---------------------------------------------------------------------------
# parameter partitioning rules (tensor parallel)
# ---------------------------------------------------------------------------

# (regex over the port's UNet parameter names) -> the dimension cut over tp.
# A flax kernel is (in, out) and a torch Linear.weight (out, in), so JAX's
# P(None, "tp") is dimension 0 here and P("tp", None) dimension 1
# (pww_tpu/parallel/mesh.py:71-80). The IP-Adapter's to_k_ip / to_v_ip are
# cut like to_k / to_v, to match the rank's query heads; JAX keeps them
# whole and GSPMD re-slices them.
_TP_RULES = [
    (r".*attn\d\.to_(q|k|v)\.weight$", 0),
    (r".*attn\d\.to_(k|v)_ip\.weight$", 0),
    (r".*attn\d\.to_out\.0\.weight$", 1),
    (r".*attn\d\.to_out\.0\.bias$", None),
    (r".*ff\.net\.0\.proj\.weight$", 0),  # GEGLU [hidden; gate]: rows of each half
    (r".*ff\.net\.0\.proj\.bias$", 0),
    (r".*ff\.net\.2\.weight$", 1),
]


def param_pspec(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` cut over tp; None: whole."""
    for pat, dim in _TP_RULES:
        if re.fullmatch(pat, name):
            return dim
    return None


def cut_index(name: str, full: int, rank: int, size: int) -> torch.Tensor:
    """The indices along the cut dimension that rank ``rank`` of ``size``
    keeps: a contiguous block, or for GEGLU's ``proj`` (``[hidden; gate]``
    stacked) the same block of each half."""
    if re.fullmatch(r".*ff\.net\.0\.proj\.(weight|bias)$", name):
        half = full // 2
        k = half // size
        block = torch.arange(rank * k, (rank + 1) * k)
        return torch.cat([block, half + block])
    k = full // size
    return torch.arange(rank * k, (rank + 1) * k)


def tp_of(mesh) -> Tuple[int, int, object]:
    """(tp rank, tp size, "tp" group) of this process in ``mesh``."""
    return mesh.get_local_rank(TP_AXIS), mesh.size(1), mesh.get_group(TP_AXIS)


def shard_params(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut, in place, the UNet's transformer blocks over the mesh's tp axis:
    the parameters :data:`_TP_RULES` names keep this rank's slice (the old
    full tensors are released), and the blocks' attentions and feed-forward
    take the tp group. A block whose head count tp does not divide stays
    whole on every rank and issues no collective (SD-2.1's 5-head level at
    tp 2, its 5- and 10-head levels at tp 4, SDXL's 10-head level at tp
    4, the tiny configs' 4 heads at tp 8); GSPMD gives the same numbers
    there. ``module`` must be whole. Returns it, with ``module.tp_cuts``
    {parameter name: (dim, full size)} for :func:`full_state` and the
    LoRA merge."""
    from ..models.unet import BasicTransformerBlock

    rank, size, group = tp_of(mesh)
    cuts: Dict[str, Tuple[int, int]] = {}
    if size > 1:
        tp = TensorParallel(group, rank, size)
        for prefix, blk in module.named_modules():
            if not isinstance(blk, BasicTransformerBlock) or blk.attn1.heads % size:
                continue
            for name, p in list(blk.named_parameters()):
                full_name = f"{prefix}.{name}"
                dim = param_pspec(full_name)
                if dim is None:
                    continue
                idx = cut_index(full_name, p.shape[dim], rank, size).to(p.device)
                owner, _, leaf = name.rpartition(".")
                sub = blk.get_submodule(owner)
                setattr(sub, leaf, torch.nn.Parameter(
                    p.detach().index_select(dim, idx).contiguous(),
                    requires_grad=p.requires_grad))
                cuts[full_name] = (dim, p.shape[dim])
            blk.attn1.tp = blk.attn2.tp = blk.ff.tp = tp
    module.tp_cuts = cuts
    return module


def full_state(module: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The state dict the module had before :func:`shard_params`: every cut
    tensor gathered over tp and put back in its place."""
    state = module.state_dict()
    cuts = getattr(module, "tp_cuts", {})
    if not cuts:
        return state
    rank, size, group = tp_of(mesh)
    out = dict(state)
    for name, (dim, full) in cuts.items():
        t = state[name].contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        shape = list(t.shape)
        shape[dim] = full
        whole = t.new_empty(shape)
        idx = torch.cat([cut_index(name, full, r, size) for r in range(size)]).to(t.device)
        out[name] = whole.index_copy_(dim, idx, torch.cat(parts, dim=dim))
    return out


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This dp rank's contiguous block of the leading (batch) axis; the whole
    tensor where dp does not divide it (JAX's fallback to replication,
    ``pww_tpu/parallel/mesh.py:103-113``)."""
    dp, r = mesh.size(0), mesh.get_local_rank(DP_AXIS)
    if x.dim() < 1 or x.shape[0] % dp:
        return x
    k = x.shape[0] // dp
    return x[r * k:(r + 1) * k]


def gather_batch(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The inverse of :func:`shard_batch` for a batch of ``n`` rows: the dp
    group's blocks in rank order (``x`` itself where it has all ``n``)."""
    if x.shape[0] == n:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(DP_AXIS))
    return torch.cat(parts)


def shard_spatial(latents, mesh):
    """Spatial sharding (``pww_tpu/parallel/mesh.py:116-126``) is not ported
    yet (ROADMAP A.20b)."""
    raise NotImplementedError("shard_spatial is not ported to pww_tpu_torch yet "
                              "(ROADMAP A.20b)")


def replicate(tree, mesh):
    """Every rank holds the whole value already: the identity, for the API."""
    return tree


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, tmp: str,
               args: tuple) -> None:
    if backend == "nccl":
        _require_cuda("spawn(backend='nccl')")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'init')}",
                            world_size=world_size, rank=rank)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world_size: int, backend: str = "nccl", *args) -> List:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh local processes joined
    into one process group (``backend``: ``"nccl"``, the default, one card
    a rank; ``"gloo"`` for the CPU or for ranks that share a card); returns
    each rank's return value, pickled back, in rank order. The group
    rendezvous through a file in a temporary directory, so that concurrent
    launches never contend for a port. A rank that raises makes ``spawn``
    raise. ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    if backend == "nccl":
        _require_cuda("spawn(backend='nccl')")
    with tempfile.TemporaryDirectory(prefix="pww_spawn_") as tmp:
        mp.spawn(_rank_main, args=(fn, world_size, backend, tmp, args),
                 nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
