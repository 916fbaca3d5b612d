"""pww_tpu_torch — paint-with-words Stable Diffusion in PyTorch, with CUDA
kernels for Hopper.

The PyTorch port of :mod:`pww_tpu`, module for module, with its public
names: the configs (and the IP-Adapter's ``CLIPVisionConfig`` and
``IpState``), the weight functions, the reference-shaped facade
(``paint_with_words``, ``paint_with_words_inpaint``, ``pww_load_tools``),
``PwwPipeline``, ``PwwState``, ``apply_textual_inversion`` and
``train_textual_inversion`` (:mod:`pww_tpu_torch.training` also trains
LoRAs), and ``MeshConfig`` and ``make_mesh`` (multi-GPU,
:mod:`pww_tpu_torch.parallel`). The kernels build at their first launch on
a card, not at import.
"""
__version__ = "0.1.0"

from .config import (  # noqa: F401
    CLIPTextConfig,
    CLIPVisionConfig,
    MeshConfig,
    SchedulerConfig,
    SDModelConfig,
    UNetConfig,
    VAEConfig,
)
from .ops.weight_functions import (  # noqa: F401
    CustomWeightFunction,
    WeightFunction,
    as_weight_function,
)
from .parallel.mesh import make_mesh  # noqa: F401
from .pipeline.facade import (  # noqa: F401
    paint_with_words,
    paint_with_words_inpaint,
    pww_load_tools,
)
from .pipeline.pipeline import PwwPipeline  # noqa: F401
from .training import train_textual_inversion  # noqa: F401
from .types import IpState, PwwState  # noqa: F401
from .weights.textual_inversion import apply_textual_inversion  # noqa: F401
