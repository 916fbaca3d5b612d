"""Milliseconds of the pipeline's "denoise" phase (PhaseTimer, which
synchronises the card) over the UNet visits of the window's calls."""
from portbench.layers import denoise_ms_per_visit as read  # noqa: F401
