"""``paint_with_words(...)`` with the reference's keyword surface, txt2img.

Port of :func:`pww_tpu.pipeline.facade.paint_with_words`. The checkpoint
loaders are not ported yet, so the caller passes a ready pipeline as
``preloaded_utils``; img2img (``init_image``, ``strength``) and
``model_token`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from ..ops.weight_functions import DEFAULT_TXT2IMG, as_weight_function
from .pipeline import PwwPipeline


def paint_with_words(
    color_context: Optional[Dict] = None,
    color_map_image=None,
    input_prompt: str = "",
    num_inference_steps: int = 30,
    guidance_scale: float = 7.5,
    seed: int = 0,
    scheduler_type: str = "lms",
    device: str = "cuda",
    weight_function: Optional[Callable] = None,
    local_model_path: Optional[str] = None,
    hf_model_path: Optional[str] = None,
    preloaded_utils: Optional[PwwPipeline] = None,
    unconditional_input_prompt: str = "",
    model_token: Optional[str] = None,
    init_image=None,
    strength: float = 0.5,
    num_samples: int = 1,
    noise_mode: str = "torch",
    **extra,
):
    """txt2img with paint-with-words (reference ``:391-510``).

    Default weight function: the reference's ``0.1 · w · log(1+σ) · max(QKᵀ)``.
    ``**extra`` is forwarded to :meth:`PwwPipeline.generate`.
    """
    if preloaded_utils is None or local_model_path or hf_model_path:
        raise NotImplementedError(
            "checkpoint loading is not ported to pww_tpu_torch yet: pass "
            "preloaded_utils=PwwPipeline(...)"
        )
    if model_token is not None:
        raise NotImplementedError("model_token goes with hf_model_path, which is not ported yet")
    if init_image is not None or strength != 0.5:
        raise NotImplementedError("img2img (init_image, strength) is not ported to "
                                  "pww_tpu_torch yet")
    if scheduler_type != "lms":
        raise NotImplementedError(f"scheduler {scheduler_type!r} is not ported yet")
    if preloaded_utils.device.type != str(device).split(":")[0]:
        raise ValueError(f"device={device!r} but the pipeline runs on "
                         f"{preloaded_utils.device}")
    wf = DEFAULT_TXT2IMG if weight_function is None else as_weight_function(weight_function)
    return preloaded_utils.generate(
        prompt=input_prompt,
        color_map_image=color_map_image,
        color_context=color_context or {},
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale,
        seed=seed,
        weight_function=wf,
        negative_prompt=unconditional_input_prompt,
        num_samples=num_samples,
        noise_mode=noise_mode,
        **extra,
    )
