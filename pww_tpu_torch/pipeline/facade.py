"""``paint_with_words(...)`` and ``paint_with_words_inpaint(...)`` with the
reference's keyword surface.

Port of :mod:`pww_tpu.pipeline.facade`. The checkpoint loaders are not
ported yet, so the caller passes a ready pipeline as ``preloaded_utils``;
``model_token`` raises ``NotImplementedError``.
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
    """txt2img, or img2img with ``init_image``, with paint-with-words
    (reference ``:391-510``).

    Default weight function: the reference's ``0.1 · w · log(1+σ) · max(QKᵀ)``.
    ``**extra`` is forwarded to :meth:`PwwPipeline.generate`.
    """
    _check_loading(preloaded_utils, device, scheduler_type, local_model_path,
                   hf_model_path, model_token)
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
        init_image=init_image,
        strength=strength,
        num_samples=num_samples,
        noise_mode=noise_mode,
        **extra,
    )


def paint_with_words_inpaint(
    color_context: Optional[Dict] = None,
    color_map_image=None,
    init_image=None,
    mask_image=None,
    input_prompt: str = "",
    num_inference_steps: int = 150,
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
    strength: float = 1.0,
    num_samples: int = 1,
    noise_mode: str = "torch",
    mask_blur: float = 0.0,
    masked_content: str = "original",
    inpaint_full_res: bool = False,
    inpaint_full_res_padding: int = 32,
    **extra,
):
    """Inpainting with paint-with-words (reference inpaint.py:137-270).

    A 9-channel inpainting UNet takes the reference's conditioned path; a
    4-channel one the legacy masked blend. The color map and the mask are
    resized (nearest) to the init image's size, as in the reference
    (:171-173). Default weight function: ``0.1 · w · log(1+σ) · max(QKᵀ)``,
    the reference function's own default; its example runners pass
    :data:`~pww_tpu_torch.ops.weight_functions.DEFAULT_INPAINT` (0.15).
    ``**extra`` is forwarded to :meth:`PwwPipeline.generate`.
    """
    import numpy as np
    from PIL import Image

    _check_loading(preloaded_utils, device, scheduler_type, local_model_path,
                   hf_model_path, model_token)
    wf = DEFAULT_TXT2IMG if weight_function is None else as_weight_function(weight_function)
    if init_image is not None and color_map_image is not None:
        if isinstance(init_image, Image.Image):
            size = init_image.size
        else:
            arr = np.asarray(init_image)
            size = (arr.shape[1], arr.shape[0])
        if not isinstance(color_map_image, Image.Image):
            color_map_image = Image.fromarray(np.asarray(color_map_image))
        color_map_image = color_map_image.resize(size, Image.NEAREST)
        if mask_image is not None:
            if not isinstance(mask_image, Image.Image):
                m = np.asarray(mask_image)
                if m.dtype != np.uint8:
                    m = (np.clip(m, 0, 1) * 255).astype(np.uint8)
                mask_image = Image.fromarray(m)
            mask_image = mask_image.resize(size, Image.NEAREST)
    return preloaded_utils.generate(
        prompt=input_prompt,
        color_map_image=color_map_image,
        color_context=color_context or {},
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale,
        seed=seed,
        weight_function=wf,
        negative_prompt=unconditional_input_prompt,
        init_image=init_image,
        mask_image=mask_image,
        strength=strength,
        num_samples=num_samples,
        noise_mode=noise_mode,
        mask_blur=mask_blur,
        masked_content=masked_content,
        inpaint_full_res=inpaint_full_res,
        inpaint_full_res_padding=inpaint_full_res_padding,
        **extra,
    )


def _check_loading(pipe, device, scheduler_type, local_model_path, hf_model_path,
                   model_token) -> None:
    if pipe is None or local_model_path or hf_model_path:
        raise NotImplementedError(
            "checkpoint loading is not ported to pww_tpu_torch yet: pass "
            "preloaded_utils=PwwPipeline(...)"
        )
    if model_token is not None:
        raise NotImplementedError("model_token goes with hf_model_path, which is not ported yet")
    if scheduler_type != "lms":
        raise NotImplementedError(f"scheduler {scheduler_type!r} is not ported yet")
    if pipe.device.type != str(device).split(":")[0]:
        raise ValueError(f"device={device!r} but the pipeline runs on {pipe.device}")
