"""``paint_with_words(...)``, ``paint_with_words_inpaint(...)`` and
``pww_load_tools(...)`` with the reference's keyword surface.

Port of :mod:`pww_tpu.pipeline.facade`. A pipeline comes from
``preloaded_utils``, or from ``pww_load_tools``, which loads a local
diffusers-layout directory once per (path, scheduler, device). There is no
network: a path that does not exist (a hub id) raises
``FileNotFoundError``, and ``model_token`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.weight_functions import DEFAULT_TXT2IMG, as_weight_function
from ..schedulers.schedules import make_scheduler
from .pipeline import PwwPipeline

_PIPELINE_CACHE: Dict[Tuple, PwwPipeline] = {}
_NO_TOKENS = ("model_token authenticates hub downloads, and pww_tpu_torch loads local "
              "directories only")


def pww_load_tools(
    device: str = "cuda",
    scheduler_type: str = "lms",
    local_model_path: Optional[str] = None,
    hf_model_path: Optional[str] = None,
    model_token: Optional[str] = None,
) -> PwwPipeline:
    """Reference-shaped loader (reference ``paint_with_words.py:128-204``):
    a ready :class:`PwwPipeline` on ``device`` (bf16 on the card, f32 on
    the CPU), cached per (path, scheduler, device), so that repeated calls
    load nothing."""
    if model_token is not None:
        raise NotImplementedError(_NO_TOKENS)
    path = local_model_path or hf_model_path
    key = (path, scheduler_type, str(device))
    if key not in _PIPELINE_CACHE:
        if path is None:
            raise ValueError("either local_model_path or hf_model_path must be provided")
        if not os.path.exists(path):
            hint = (" (looks like a Hugging Face hub id: there is no network here; "
                    "download the checkpoint elsewhere and pass its local directory as "
                    "local_model_path)" if local_model_path is None else "")
            raise FileNotFoundError(f"model path {path!r} does not exist locally{hint}")
        dtype = torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16
        _PIPELINE_CACHE[key] = PwwPipeline.from_pretrained(
            path, scheduler=scheduler_type, device=device, dtype=dtype)
    return _PIPELINE_CACHE[key]


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
    noise_mode: str = "jax",
    **extra,
):
    """txt2img, or img2img with ``init_image``, with paint-with-words
    (reference ``:391-510``).

    Default weight function: the reference's ``0.1 · w · log(1+σ) · max(QKᵀ)``.
    ``**extra`` is forwarded to :meth:`PwwPipeline.generate`.
    """
    pipe = _pipeline(preloaded_utils, device, scheduler_type, local_model_path,
                     hf_model_path, model_token)
    wf = DEFAULT_TXT2IMG if weight_function is None else as_weight_function(weight_function)
    return pipe.generate(
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
    noise_mode: str = "jax",
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

    pipe = _pipeline(preloaded_utils, device, scheduler_type, local_model_path,
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
    return pipe.generate(
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


def _pipeline(pipe, device, scheduler_type, local_model_path, hf_model_path,
              model_token) -> PwwPipeline:
    """``preloaded_utils`` as given (the reference ignores ``scheduler_type``
    for it), else :func:`pww_load_tools`. A scheduler the port lacks
    raises either way."""
    make_scheduler(scheduler_type)
    if pipe is None:
        return pww_load_tools(device, scheduler_type, local_model_path=local_model_path,
                              hf_model_path=hf_model_path, model_token=model_token)
    if model_token is not None:
        raise NotImplementedError(_NO_TOKENS)
    if pipe.device.type != str(device).split(":")[0]:
        raise ValueError(f"device={device!r} but the pipeline runs on {pipe.device}")
    return pipe
