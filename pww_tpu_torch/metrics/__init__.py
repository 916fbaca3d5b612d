"""Perceptual metrics."""
from .lpips import (  # noqa: F401
    init_random_lpips,
    load_lpips_from_files,
    load_lpips_from_torch_state,
    lpips_distance,
)
