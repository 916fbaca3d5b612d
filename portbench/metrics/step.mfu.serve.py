"""The whole step's share of the card's bf16 peak, in the profiled call: the
reference's FLOPs of its samples (roofline/flops.py: text encode, UNet
visits, decode) over the call's span on the card's clock, over 989 TFLOP/s,
%."""
from portbench.layers import step_mfu as read  # noqa: F401
