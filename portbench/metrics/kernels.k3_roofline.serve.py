"""K3 (flash self-attention, ``flash_kernel``) in the profiled call: the
least time its launches could take (roofline/kernels.py, at the shapes of
roofline/sites.py) over their device time, %."""
from portbench.layers import roofline


def read(run):
    return roofline(run, ("K3",))
