"""K1 + K2 (the PwW reduce ``pww_reduce_kernel`` and the PwW cross-attention
``pww_xattn_kernel``) in the profiled call: the least time their launches
could take over their device time, %."""
from portbench.layers import roofline


def read(run):
    return roofline(run, ("K1", "K2"))
