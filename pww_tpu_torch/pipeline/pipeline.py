"""PwwPipeline — the paint-with-words pipeline, txt2img.

Port of the txt2img subset of :class:`pww_tpu.pipeline.pipeline.PwwPipeline`:

  * encode: tokenize, parse the color context, rasterize the bias pyramid
    on the device, CLIP-encode ([uncond, cond]);
  * denoise: a Python loop of LMS steps; cond and uncond go through ONE
    batched UNet call per step, then classifier-free guidance. Latents and
    scheduler state stay f32; the UNet runs in the compute dtype;
  * decode: VAE decode to uint8 on the device, one copy to the host.

Everything else the JAX pipeline's ``generate`` takes raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..conditioning.encode import EncodedInputs, encode_text_color_inputs
from ..conditioning.seeding import make_noise, regional_seed_latents
from ..config import SDModelConfig
from ..ops.weight_functions import (AnyWeightFunction, CustomWeightFunction,
                                    as_weight_function)
from ..schedulers.schedules import make_scheduler
from ..weights.bridge import StateDicts, build_models, synthetic_params


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller names the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pww_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def _to_numpy_image(img) -> Optional[np.ndarray]:
    if img is None or isinstance(img, np.ndarray):
        return img
    return np.array(img)


class PwwPipeline:
    """Stable-Diffusion paint-with-words pipeline (txt2img).

    ``params``: {"unet", "clip", "vae"} state dicts with diffusers' key names
    (:func:`~pww_tpu_torch.weights.bridge.params_from_jax`, or None for
    :func:`~pww_tpu_torch.weights.bridge.synthetic_params` drawn from
    ``seed``). ``device`` defaults to the card; on it the compute dtype is
    bf16. Latents and scheduler state stay f32 either way.
    """

    def __init__(
        self,
        config: Optional[SDModelConfig] = None,
        params: Optional[StateDicts] = None,
        tokenizer=None,
        scheduler: str = "lms",
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        profile: bool = False,  # record per-phase seconds in self.timings
    ):
        self.config = config or SDModelConfig.sd15()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError("on a CUDA device the pipeline computes in bf16 "
                             "(the CUDA kernels take bf16)")
        self.dtype = dtype
        self.scheduler = make_scheduler(scheduler, self.config.scheduler)
        if tokenizer is None:
            from ..tokenizer.clip_bpe import toy_tokenizer

            if self.config.clip.vocab_size > 2048:
                import warnings

                warnings.warn(
                    "No tokenizer given for a full-size CLIP config: falling "
                    "back to the hash-based toy tokenizer, which does NOT "
                    "produce real CLIP token ids.",
                    stacklevel=2,
                )
            tokenizer = toy_tokenizer(self.config.clip.vocab_size)
        self.tokenizer = tokenizer
        if params is None:
            params = synthetic_params(self.config, seed, self.device, dtype)
        models = build_models(self.config)  # on the meta device
        for part, module in models.items():
            sd = {k: v.to(device=self.device, dtype=dtype) for k, v in params[part].items()}
            module.load_state_dict(sd, strict=True, assign=True)
            module.eval().requires_grad_(False)
        self.unet, self.clip, self.vae = models["unet"], models["clip"], models["vae"]
        self.profile = profile
        self.timings: Dict[str, float] = {}

    # -- stages ----------------------------------------------------------------
    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.clip(ids)

    def encode_inputs(self, prompt: str, color_map: Optional[np.ndarray],
                      color_context: Dict, negative_prompt: str = "",
                      weight_function: Optional[AnyWeightFunction] = None,
                      ) -> EncodedInputs:
        return encode_text_color_inputs(
            self.encode_text, self.tokenizer, color_map, color_context,
            prompt, negative_prompt, weight_function, device=self.device,
        )

    def denoise(self, latents, text_states, pww, schedule, guidance_scale):
        """The LMS loop; latents (N, C, h, w) f32 in and out. Cond and uncond
        go through one batched UNet call per step."""
        n = latents.shape[0]
        lat = latents.float()
        history = []
        for i in range(schedule.num_steps):
            lat_in = schedule.scale_model_input(lat, i).to(self.dtype)
            eps2 = self.unet(torch.cat([lat_in, lat_in]), schedule.timesteps[i],
                             text_states, pww.with_sigma(schedule.sigma(i)))
            out_u, out_c = eps2[:n].float(), eps2[n:].float()
            eps = out_u + guidance_scale * (out_c - out_u)
            lat, history = schedule.step(eps, i, lat, history)
        return lat

    def decode_uint8(self, latents: torch.Tensor) -> np.ndarray:
        """Latents (N, C, h, w) → (N, H, W, 3) uint8 (reference `_pil_from_latents`)."""
        img = self.vae.decode(latents / self.config.vae.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        img = torch.round(img * 255.0).to(torch.uint8)
        return img.permute(0, 2, 3, 1).cpu().numpy()

    def _phase(self, name, t0):
        if self.profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = time.perf_counter() - t0
        return time.perf_counter()

    # -- generation --------------------------------------------------------------
    @torch.inference_mode()
    def generate(
        self,
        prompt: str = "",
        color_map_image=None,  # PIL.Image | (H, W, 3) uint8 array | None
        color_context: Optional[Dict] = None,
        num_inference_steps: int = 30,
        guidance_scale: float = 7.5,
        seed: int = 0,
        weight_function: Optional[AnyWeightFunction] = None,
        negative_prompt: str = "",
        num_samples: int = 1,
        noise_mode: str = "torch",
        output_type: str = "pil",
        return_latents: bool = False,
        **unported,
    ):
        """txt2img with paint-with-words. Returns PIL image(s), a
        (N, H, W, 3) uint8 array (``output_type="np"``), or with
        ``return_latents`` the final (N, h, w, 4) f32 latents (NHWC)."""
        if unported:
            raise NotImplementedError(
                f"generate({', '.join(sorted(unported))}=...) is not ported to "
                "pww_tpu_torch yet (txt2img only)"
            )
        if isinstance(as_weight_function(weight_function), CustomWeightFunction):
            # the reference's two-forward CFG (uncond without any bias) that
            # custom callables need is not ported yet
            raise NotImplementedError(
                "custom weight functions are not ported to pww_tpu_torch's "
                "pipeline yet; use a WeightFunction"
            )
        if output_type not in ("pil", "np"):
            raise ValueError(f"output_type must be 'pil' or 'np', got {output_type!r}")
        cfg = self.config
        t0 = time.perf_counter()
        color_map = _to_numpy_image(color_map_image)
        enc = self.encode_inputs(prompt, color_map, color_context or {},
                                 negative_prompt, weight_function)
        if color_map is not None:
            height, width = enc.height, enc.width
        else:
            height = width = 512
        sf = cfg.vae.scale_factor
        n = num_samples
        shape = (n, cfg.vae.latent_channels, height // sf, width // sf)
        schedule = self.scheduler.set_timesteps(num_inference_steps, self.device)
        lat = make_noise(seed, shape, noise_mode, self.device)
        lat = regional_seed_latents(lat, enc.regions, noise_mode)
        lat = lat * schedule.init_noise_sigma

        text_states, pww = enc.text_states, enc.pww
        if n > 1:  # rows [uncond*N, cond*N]
            def tile(x):
                return torch.cat([x[:1].expand(n, *x.shape[1:]),
                                  x[1:].expand(n, *x.shape[1:])])

            text_states = tile(text_states)
            pww = dataclasses.replace(
                pww, weights={k: tile(v) for k, v in pww.weights.items()},
                weight_orig=tile(pww.weight_orig),
            )
        t0 = self._phase("encode", t0)
        lat = self.denoise(lat, text_states, pww, schedule, float(guidance_scale))
        t0 = self._phase("denoise", t0)
        if return_latents:
            return lat.permute(0, 2, 3, 1).cpu().numpy()
        images = self.decode_uint8(lat)
        self._phase("decode", t0)
        if output_type == "np":
            return images
        from PIL import Image

        pil = [Image.fromarray(im) for im in images]
        return pil[0] if n == 1 else pil

    __call__ = generate
