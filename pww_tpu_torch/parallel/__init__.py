"""Multi-GPU execution: the (dp, tp) mesh, its sharding rules and a local
launcher (:mod:`pww_tpu_torch.parallel.mesh`), spatial sharding
(:mod:`pww_tpu_torch.parallel.spatial`), and the dry run
(:mod:`pww_tpu_torch.parallel.dryrun`)."""
from .mesh import (  # noqa: F401
    DP_AXIS,
    TP_AXIS,
    gather_batch,
    init_multihost,
    make_mesh,
    param_pspec,
    replicate,
    shard_batch,
    shard_params,
    shard_spatial,
    spawn,
)
