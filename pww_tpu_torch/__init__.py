"""pww_tpu_torch — paint-with-words Stable Diffusion in PyTorch, with CUDA
kernels for Hopper.

The PyTorch port of :mod:`pww_tpu`, module for module. Importing the
package loads nothing heavy; use ``pww_tpu_torch.pipeline.pipeline.PwwPipeline``
and ``pww_tpu_torch.pipeline.facade.paint_with_words``.
"""
__version__ = "0.1.0"
