"""PwwPipeline — the paint-with-words pipeline: txt2img, img2img, inpaint.

Port of :class:`pww_tpu.pipeline.pipeline.PwwPipeline` for these modes:

  * encode: tokenize, parse the color context, rasterize the bias pyramid
    on the device, CLIP-encode ([uncond, cond]); for img2img and inpaint,
    VAE-encode the init image and re-noise it at the strength's first step;
  * denoise: a Python loop over the scheduler's visits from that step
    (every kind of :mod:`~pww_tpu_torch.schedulers.schedules`); cond and
    uncond go through ONE batched UNet call per visit, each half is
    converted to ε (SD-2.x v-prediction), then classifier-free guidance
    (two calls, the uncond one without any bias, for a custom weight
    function). A 9-channel UNet takes the mask and the masked image's
    latents as extra input channels; a 4-channel one inpaints by the legacy
    masked blend. Latents and scheduler state stay f32; the UNet runs in
    the compute dtype. On the card the batched call's visits replay a CUDA
    graph of the UNet (:mod:`.graphs`);
  * decode: VAE decode to uint8 on the device, one copy to the host, and
    for ``inpaint_full_res`` the paste back into the full image.

Structural control (``pww_tpu/pipeline/pipeline.py:47-151, 780-886``): one
or more ControlNets (:meth:`PwwPipeline.load_controlnet`,
:meth:`PwwPipeline.add_controlnet`) run beside the UNet at every visit, on
the same latents, text states and paint-with-words state, and their
residuals, scaled and summed in order, join the UNet's skips and mid
block; a T2I-Adapter (:meth:`PwwPipeline.load_t2i_adapter`) turns its hint
into features once per call, which the UNet adds in its down blocks.

SDXL (``pww_tpu/pipeline/pipeline.py:571-597, 1828-1858``): the base
encodes with two towers (penultimate states concatenated, the second
tower's pooled vector), the refiner with one; the pooled vector and the
micro-conditioning ``time_ids`` (original size, crop, target size or
aesthetic score) go to the UNet on both CFG paths. diffusers' ensemble of
expert denoisers: ``denoising_end`` stops a call at a fraction of the
trajectory and returns its latents, and ``init_latents`` with
``denoising_start`` resumes it, on the same or another model.

:meth:`PwwPipeline.from_pretrained` loads a diffusers-layout directory, an
A1111/LDM single file or a JAX-written ``params.msgpack`` directory
(:mod:`~pww_tpu_torch.weights.loader`), and
:meth:`PwwPipeline.save_pretrained` writes the diffusers layout.

Serving (``pww_tpu/pipeline/pipeline.py:1213-1355, 2237-2709``):
:meth:`PwwPipeline.generate_batch` runs N independent requests (own prompt,
seed, color map, init image and mask) as one batched denoise, rows
[uncond_0..uncond_{N-1}, cond_0..cond_{N-1}], each request's noise drawn
from its own seed, so that row i is request i served alone up to the
batch's rounding; the encode prologue is cached (an LRU of 32 encodes and a
text cache of 256 encoder outputs, both under ``_encode_lock``), and a
group's uncached prompt pairs go through the text encoder in one call.
Prompt options: A1111 weighting, long prompts (n·77 text keys), CLIP skip.
``generate(callback=...)`` calls back every ``callback_steps`` visits, and
``output_type="device"`` returns the un-fetched uint8 images on the card.

The sampling extras (``pww_tpu/pipeline/pipeline.py:165-414, 1497-2236``),
per call of ``generate`` and ``generate_batch``: DeepCache
(``cache_interval``: a full UNet visit every ``cache_interval`` visits, the
shallow pass on the cached deep feature between them), ToMe
(``tome_ratio``), FreeU (``freeu``), Self-Attention Guidance
(``sag_scale``: a second, uncond-only UNet pass per visit on latents
blurred where the mid block's self-attention looks most), LCM-distilled
UNets (the guidance scale embedded as a UNet input, the external CFG scale
1.0) with the ``lcm`` scheduler; in ``generate`` alone, A1111 prompt
editing (``prompt_editing``: the conditioning switches at the schedule's
steps), and :meth:`PwwPipeline.generate_hires`, the two-pass hires fix.

Adapters (``pww_tpu/pipeline/pipeline.py:888-1158``): a LoRA merges into
the UNet's and the text towers' weights (:meth:`PwwPipeline.load_lora`;
:meth:`PwwPipeline.unload_loras` restores them bit for bit); an IP-Adapter
(:meth:`PwwPipeline.load_ip_adapter`) adds ``to_k_ip``/``to_v_ip`` to every
cross-attention and, per call, the reference image's tokens through the
CLIP vision tower and the adapter's projection (``generate(
ip_adapter_image=, ip_adapter_scale=)``, ``generate_batch(
ip_adapter_image=)``, one image shared by the batch).

Random numbers: ``noise_mode="jax"`` (the default, as in the JAX package)
draws every number the JAX package draws from ``jax.random``, the same
numbers, on the host (:mod:`pww_tpu_torch.utils.jax_random`): the initial
latent and regional seeds, the img2img posterior sample and the
masked-content fill (from ``split(rng or PRNGKey(seed))``, in either
noise mode), and the stochastic schedulers' step noise; ``"torch"`` draws
the initial latent as the reference does.

Multi-GPU (``pww_tpu/pipeline/pipeline.py:1876-1912, 1977-1995,
2634-2670``): ``PwwPipeline(mesh=make_mesh(dp, tp))`` on every rank of a
process group; ``generate(sharding="batch")`` and ``generate_batch`` draw
the whole batch's noise, run each rank's samples (dp) on its heads (tp),
and return the gathered result on every rank. ``generate(sharding=
"spatial")`` cuts one image's rows over dp instead
(:class:`~pww_tpu_torch.parallel.spatial.Spatial`): every noise is drawn
whole and cut, the text states, PwW weights and added conditions stay
whole, a ControlNet runs whole on gathered latents and its residuals are
cut, the decode is sharded too, and the latents are gathered before the
callbacks and the return. Every mode of ``generate`` and both passes of
``generate_hires`` run under it.

Everything else the JAX pipeline's ``generate`` takes raises
``NotImplementedError`` here (:data:`UNPORTED`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..conditioning.encode import (EncodedInputs, padded_ids, cache_text,
                                   encode_text_color_inputs)
from ..conditioning.seeding import (check_noise_mode, make_noise, normal_nchw,
                                   regional_seed_latents)
from ..config import SDModelConfig
from ..models.vae import sample_from_moments
from ..ops.blur import gaussian_blur
from ..ops.resize import resize_linear_antialias, resize_nearest
from ..ops.weight_functions import (AnyWeightFunction, CustomWeightFunction,
                                   as_weight_function)
from ..parallel.mesh import full_state, gather_batch, shard_batch, shard_params
from ..parallel.spatial import Spatial
from ..schedulers.schedules import make_scheduler, step_noise, t_start_from_strength
from ..types import IpState, PwwState
from ..utils import jax_random
from ..utils.profiling import PhaseTimer
from ..weights.bridge import StateDicts, build_models, synthetic_params, synthetic_state
from . import graphs as visit_graphs
from .inpaint import (blur_mask, expand_crop_region, fill_masked_region, paste_region,
                      prepare_mask_and_masked_image)

# kinds whose visits do not map 1:1 to steps (pndm, heun), or whose multistep
# tables assume a history that a truncated img2img start does not have
NO_STRENGTH_TRUNCATION = ("pndm", "heun", "unipc", "dpmpp_2m", "dpmpp_2m_sde")

# The JAX pipeline's options that the port does not have yet: the value that
# leaves each off, and the ROADMAP item that decides or ports it. Off, they
# are accepted; on, they raise. The port has them all.
UNPORTED: Dict = {}


def refuse_unported(where: str, options: Dict) -> None:
    """``NotImplementedError`` for an option the port lacks, unless it is
    off; an option the table does not know always raises."""
    for name, value in sorted(options.items()):
        if name in UNPORTED:
            off, item = UNPORTED[name]
            if (value is not None) if off is None else (value != off):
                raise NotImplementedError(f"{where}({name}=...) is not ported to "
                                          f"pww_tpu_torch yet (ROADMAP {item})")
        else:
            raise NotImplementedError(f"{where}({name}=...) is not ported to "
                                      "pww_tpu_torch yet")


def guidance_scale_embedding(w: float, dim: int, device="cpu") -> torch.Tensor:
    """The guidance scale's Fourier embedding for an LCM-distilled UNet
    (diffusers' ``get_guidance_scale_embedding``,
    ``pww_tpu/pipeline/pipeline.py:2817-2832``): (w − 1)·1000 at log-spaced
    frequencies, the sin block then the cos block, zero-padded to an odd
    ``dim``; (dim,) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32)
                      / (half - 1))
    args = torch.tensor(np.float32((w - 1.0) * 1000.0)) * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)])
    if dim % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros(1)])
    return emb.to(device)


def freeu_params(freeu, is_xl: bool) -> Optional[Tuple[float, float, float, float]]:
    """``freeu=True``: the FreeU README's defaults for the family (SD-1.x /
    2.x 1.5, 1.6, 0.9, 0.2; SDXL 1.3, 1.4, 0.9, 0.2); a tuple: (b1, b2, s1,
    s2); None: off (``pww_tpu/pipeline/pipeline.py:1171-1180``)."""
    if freeu is True:
        return (1.3, 1.4, 0.9, 0.2) if is_xl else (1.5, 1.6, 0.9, 0.2)
    if freeu is None:
        return None
    freeu = tuple(float(v) for v in freeu)
    if len(freeu) != 4:
        raise ValueError("freeu must be (b1, b2, s1, s2) or True")
    return freeu


def sag_mask(probs: torch.Tensor) -> torch.Tensor:
    """SAG's salient keys (diffusers' ``sag_masking``): (N, H, L, L)
    attention probabilities → (N, L), true where a key receives more than
    1.0 of attention summed over the queries, averaged over the heads."""
    return probs.mean(dim=1).sum(dim=1) > 1.0


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


def _image_hw(img, default: Tuple[int, int]) -> Tuple[int, int]:
    if img is None:
        return default
    arr = _to_numpy_image(img)
    return arr.shape[0], arr.shape[1]


def preprocess_image(img) -> np.ndarray:
    """PIL/array → (1, H, W, 3) f32 in [-1, 1], H and W floored to a multiple
    of 32 by a LANCZOS resize (reference ``preprocess``, `paint_with_words.py:28-35`)."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    w, h = img.size
    w, h = w - w % 32, h - h % 32
    img = img.resize((w, h), resample=Image.LANCZOS)
    x = np.asarray(img, np.float32)[None] / 255.0
    return 2.0 * x - 1.0


def _load_hint(img, channels: int, proc_hw: Tuple[int, int], name: str) -> np.ndarray:
    """A uint8 hint image → (H, W, channels) f32 in [0, 1], at the processing
    resolution (the latent grid × the VAE's factor, not the raw input's
    size); an RGB hint for a 1-channel adapter becomes its mean."""
    arr = _to_numpy_image(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if channels == 1 and arr.shape[-1] == 3:
        arr = arr.mean(-1, keepdims=True)  # mono hint (sketch, depth)
    if arr.shape[:2] != proc_hw:
        raise ValueError(f"{name} size {arr.shape[:2]} != processing resolution {proc_hw}; "
                         "resize the hint")
    if arr.ndim != 3 or arr.shape[-1] != channels:
        raise ValueError(f"{name} must be (H, W, {channels}), got {arr.shape}")
    return arr


def micro_time_ids(refiner: bool, original: Sequence[Tuple[int, int]],
                   crop: Sequence[Tuple[int, int]], target: Sequence[Tuple[int, int]],
                   aesthetic_score: float, negative_aesthetic_score: float,
                   device) -> torch.Tensor:
    """SDXL's micro-conditioning for 2N CFG rows [uncond*N, cond*N], from each
    request's (original, crop top-left, target) sizes: the base's rows are
    [h, w, top, left, target h, target w]; the refiner's [h, w, top, left,
    score], the negative score on the uncond half
    (``pww_tpu/pipeline/pipeline.py:1831-1853, 2444-2474``)."""
    if refiner:
        rows = ([[*o, *c, negative_aesthetic_score] for o, c in zip(original, crop)]
                + [[*o, *c, aesthetic_score] for o, c in zip(original, crop)])
    else:
        rows = [[*o, *c, *t] for o, c, t in zip(original, crop, target)] * 2
    return torch.tensor(rows, dtype=torch.float32, device=device)


def image_keys(seed: int, rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """img2img's and inpaint's two keys, ``split(rng or PRNGKey(seed))``:
    the VAE posterior sample's and the masked-content "latent_noise"
    fill's, in either noise mode (``pww_tpu/pipeline/pipeline.py:
    1668-1669``). ``rng`` is a (2,) uint32 key, a ``jax.random.PRNGKey``'s
    data passing as it is."""
    key = jax_random.PRNGKey(seed) if rng is None else np.asarray(rng)
    k_sample, k_noise = jax_random.split(key)
    return k_sample, k_noise


def check_masked_content(masked_content: str, mask_blur: float, inpaint: bool) -> None:
    if masked_content not in ("original", "fill", "latent_noise", "latent_nothing"):
        raise ValueError("masked_content must be one of original/fill/latent_noise/"
                         f"latent_nothing, got {masked_content!r}")
    if (masked_content != "original" or mask_blur) and not inpaint:
        raise ValueError("mask_blur/masked_content require mask_image (inpainting)")


def truncation_checked(t_start: int, schedule) -> int:
    """``t_start``, where the scheduler kind can start there."""
    if t_start > 0 and schedule.kind in NO_STRENGTH_TRUNCATION:
        raise ValueError(f"img2img strength truncation is not supported with the "
                         f"{schedule.kind} scheduler; use lms/euler/ddim")
    return t_start


def _to_output(images: np.ndarray, output_type: str, single: bool):
    """(N, H, W, 3) uint8 → the array (``"np"``), or PIL images (one where
    ``single``)."""
    if output_type == "np":
        return images
    from PIL import Image

    pil = [Image.fromarray(im) for im in images]
    return pil[0] if single else pil


class BatchRows:
    """This dp rank's samples of an N-sample call on a mesh, and the gathers
    back: each rank takes its contiguous block of the samples, from each
    CFG half of the 2N rows [uncond*N, cond*N] alike, so that its uncond
    and cond rows are those of the same samples; where dp does not divide N
    every rank takes all of them (:func:`~pww_tpu_torch.parallel.mesh.
    shard_batch`). Without a mesh (``mesh`` None) every cut and gather is
    the identity."""

    def __init__(self, mesh, n: int):
        self.mesh, self.n = mesh, n

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """N rows → this rank's."""
        return x if self.mesh is None else shard_batch(x, self.mesh)

    def cfg(self, x: torch.Tensor) -> torch.Tensor:
        """2N rows [uncond*N, cond*N] → this rank's of each half."""
        if self.mesh is None:
            return x
        n = x.shape[0] // 2
        return torch.cat([self.rows(x[:n]), self.rows(x[n:])])

    def pww(self, pww: PwwState) -> PwwState:
        return dataclasses.replace(
            pww, weights={k: self.cfg(v) for k, v in pww.weights.items()},
            weight_orig=None if pww.weight_orig is None else self.cfg(pww.weight_orig))

    def added(self, added_cond: Optional[Dict]) -> Optional[Dict]:
        return None if added_cond is None else {k: self.cfg(v) for k, v in added_cond.items()}

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows → all N, on every rank."""
        return x if self.mesh is None else gather_batch(x, self.mesh, self.n)

    def hint(self, x: torch.Tensor) -> torch.Tensor:
        """A ControlNet hint (N rows) → this rank's."""
        return self.rows(x)

    def whole_shape(self, lat: torch.Tensor):
        """The shape of the whole draw whose rows ``lat`` holds."""
        return (self.n, *lat.shape[1:])

    def whole(self, fn: Callable, *xs):
        """``fn`` on this rank's samples (spatial sharding's hook)."""
        return fn(*xs)

    def sites(self):
        return contextlib.nullcontext()


class PwwPipeline:
    """Stable-Diffusion paint-with-words pipeline (txt2img, img2img, inpaint).

    ``params``: {"unet", "clip", "vae"} (SDXL-base: and "clip2") state dicts
    with diffusers' key names
    (:meth:`from_pretrained` reads them from a directory;
    :func:`~pww_tpu_torch.weights.bridge.params_from_jax`; or None for
    :func:`~pww_tpu_torch.weights.bridge.synthetic_params` drawn from
    ``seed``). ``device`` defaults to the card; on it the compute dtype is
    bf16. Latents and scheduler state stay f32 either way. ``tokenizer_2``:
    SDXL-base's second tokenizer (default: ``tokenizer``).

    ``mesh``: a (dp, tp) ``DeviceMesh`` (:func:`~pww_tpu_torch.parallel.
    mesh.make_mesh`); every rank builds the pipeline and calls it with the
    same arguments, and each gets the whole result. The UNet's transformer
    blocks are cut over tp at construction and after :meth:`load_lora`,
    :meth:`unload_loras` and :meth:`load_ip_adapter`, where the JAX
    pipeline re-shards (``pww_tpu/pipeline/pipeline.py:676-680, 915-918,
    1051-1054, 1153-1156``); the text towers, the VAE, ControlNets and the
    T2I-Adapter stay whole, as the JAX rules reach none of them. A call's
    samples are cut over dp (:class:`BatchRows`).
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
        profile: bool = False,  # record per-phase seconds in self.timings / timers
        tokenizer_2=None,
        mesh=None,  # a ("dp", "tp") DeviceMesh (parallel.mesh.make_mesh) for multi-GPU
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
        self.tokenizer_2 = (tokenizer_2 or tokenizer) if self.config.is_xl else None
        if params is None:
            params = synthetic_params(self.config, seed, self.device, dtype)
        # CUDA graphs of the denoise loop's UNet visits (graphs.py)
        self.unet_graphs = visit_graphs.VisitGraphs(self.device)
        models = build_models(self.config)  # on the meta device
        for part, module in models.items():
            self._place(module, params[part])
        self.unet, self.clip, self.vae = models["unet"], models["clip"], models["vae"]
        self.clip2 = models.get("clip2")
        self.mesh = mesh
        if mesh is not None:
            shard_params(self.unet, mesh)
        self.controlnets: List[torch.nn.Module] = []  # more than one: multi-ControlNet
        self.t2i_adapter: Optional[torch.nn.Module] = None
        self._lora_saved: Dict[str, Dict[str, torch.Tensor]] = {}  # pre-LoRA tensors
        self._ip: Optional[Dict] = None  # the attached IP-Adapter (load_ip_adapter)
        self.profile = profile
        self.timers = PhaseTimer()  # every profiled call's seconds per phase
        # encode caches (pww_tpu/pipeline/pipeline.py:1213-1355): one lock
        # guards both and the warnings capture, which swaps process-wide filters
        self._encode_cache: Dict = {}  # LRU of 32 encodes, with their warnings
        self._text_cache: Dict = {}  # the text encoder's output, 256 entries
        self._encode_lock = threading.Lock()

    @classmethod
    def from_pretrained(cls, model_path: str, scheduler: Optional[str] = None,
                        **kwargs) -> "PwwPipeline":
        """A pipeline on a checkpoint that
        :func:`~pww_tpu_torch.weights.loader.load_pipeline_checkpoint`
        reads: a diffusers-layout directory (SD-1.x, SD-1.x inpainting,
        SD-2.x, SDXL base and refiner; ``.safetensors`` or ``.bin`` weights
        and the tokenizers' files), one A1111/LDM ``.ckpt`` or
        ``.safetensors`` file, or a directory the JAX package's
        ``save_pretrained`` or converter wrote (``params.msgpack``).
        ``scheduler=None`` takes the ``scheduler_type`` a top-level
        ``config.json`` records, else "lms". The weights go to the
        pipeline's device and dtype (``**kwargs``: the constructor's)."""
        from ..weights.loader import load_pipeline_checkpoint, recorded_scheduler

        config, params, tokenizer, tokenizer_2 = load_pipeline_checkpoint(model_path)
        if scheduler is None:
            scheduler = recorded_scheduler(model_path)
        return cls(config=config, params=params, tokenizer=tokenizer, scheduler=scheduler,
                   tokenizer_2=tokenizer_2, **kwargs)

    def save_pretrained(self, path: str) -> None:
        """Write the pipeline to ``path`` in the diffusers layout
        (:func:`~pww_tpu_torch.weights.loader.save_diffusers_checkpoint`:
        the weights as ``.safetensors`` in their own type, the tokenizers'
        files for a real-BPE tokenizer) with a top-level ``config.json``
        recording the scheduler. :meth:`from_pretrained` reads it back, and
        so does the JAX package's, by its diffusers branch (there is no
        ``params.msgpack``: the port writes no flax tree). Config fields
        that the diffusers files do not carry come back at their defaults."""
        import json
        import os

        from ..weights.loader import save_diffusers_checkpoint

        parts = {"unet": self.unet, "clip": self.clip, "vae": self.vae}
        if self.clip2 is not None:
            parts["clip2"] = self.clip2
        save_diffusers_checkpoint(path, self.config,
                                  {part: m.state_dict() for part, m in parts.items()},
                                  self.tokenizer, tokenizer_2=self.tokenizer_2)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"scheduler_type": self.scheduler.kind}, f, indent=1)

    def _place(self, module: torch.nn.Module, state) -> torch.nn.Module:
        """A module built on the meta device, given ``state`` on this
        pipeline's device and dtype, for inference. New weight storage:
        the captured UNet visits are dropped."""
        sd = {k: v.to(device=self.device, dtype=self.dtype) for k, v in state.items()}
        module.load_state_dict(sd, strict=True, assign=True)
        self.unet_graphs.invalidate()
        return module.eval().requires_grad_(False)

    # -- ControlNet and T2I-Adapter ----------------------------------------------
    def load_controlnet(self, source: Optional[str] = None, params=None, seed: int = 0):
        """Attach a ControlNet for the pipeline's UNet config, replacing any
        attached ones (``pww_tpu/pipeline/pipeline.py:780-812``). ``source``:
        a diffusers ControlNet directory or file; ``params``: the port's
        state dict; neither: N(0, 0.02) from ``seed`` with the zero convs
        zero, a net that adds nothing until trained. On an SDXL config the net
        is SDXL's (``text_time``, with its own ``add_embedding``). Returns the
        pipeline."""
        from ..models.controlnet import ZERO_CONV_PREFIXES

        net = build_models(self.config, parts=("controlnet",))["controlnet"]
        if params is None and source is not None:
            from ..weights.loader import load_controlnet_checkpoint

            params = load_controlnet_checkpoint(source, self.config)
        elif params is None:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            params = synthetic_state(net, g, self.dtype)
            for k, v in params.items():
                if k.startswith(ZERO_CONV_PREFIXES):
                    v.zero_()
        self.controlnets = [self._place(net, params)]
        return self

    def add_controlnet(self, source: Optional[str] = None, params=None, seed: int = 1):
        """Stack another ControlNet (diffusers' ``MultiControlNetModel``):
        at ``generate`` each net takes its own ``control_image`` and
        conditioning scale, and their residuals are summed."""
        stacked = self.controlnets
        self.load_controlnet(source=source, params=params, seed=seed)
        self.controlnets = stacked + self.controlnets
        return self

    def load_t2i_adapter(self, source=None, params=None, in_channels: int = 3,
                         channels: Optional[Sequence[int]] = None, num_res_blocks: int = 2,
                         seed: int = 0):
        """Attach a T2I-Adapter (diffusers' full ``T2IAdapter``; ``channels``
        default to the UNet's blocks). ``source``: a ``.safetensors``/``.bin``
        path or a state dict with diffusers' keys, bare or under
        ``adapter.``; ``params``: the port's state dict; neither: N(0, 0.02)
        from ``seed``. Returns the pipeline."""
        from ..models.t2i_adapter import T2IAdapter

        with torch.device("meta"):
            adapter = T2IAdapter(tuple(channels or self.config.unet.block_out_channels),
                                 num_res_blocks, self.config.vae.scale_factor, in_channels)
        if params is None and source is not None:
            from ..weights.loader import t2i_adapter_state_dict

            params = t2i_adapter_state_dict(source, adapter.state_dict())
        elif params is None:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            params = synthetic_state(adapter, g, self.dtype)
        self.t2i_adapter = self._place(adapter, params)
        return self

    # -- LoRA and IP-Adapter -------------------------------------------------------
    def _towers(self) -> Dict[str, torch.nn.Module]:
        towers = {"unet": self.unet, "clip": self.clip}
        if self.clip2 is not None:
            towers["clip2"] = self.clip2
        return towers

    def _assign(self, module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
        """Replace the named parameters of ``module`` by ``tensors``; the
        captured UNet visits are dropped."""
        for key, t in tensors.items():
            owner, _, leaf = key.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    torch.nn.Parameter(t, requires_grad=False))
        self.unet_graphs.invalidate()

    def load_lora(self, source, scale: float = 1.0) -> int:
        """Merge a LoRA into the UNet and text towers' weights
        (``pww_tpu/pipeline/pipeline.py:888-921``). ``source``: a
        ``.safetensors``/``.bin`` path, a raw state dict or a parsed
        :class:`~pww_tpu_torch.weights.lora.LoraWeights`; kohya and
        diffusers/peft layouts. Calls stack, each at its own scale. Returns
        the number of modules merged; :meth:`unload_loras` restores the
        weights bit for bit. The encode caches are dropped when a text
        tower's weights changed. On a mesh each rank merges into its slices
        of the cut UNet weights the same slice of ``up @ down``, from
        ``up``'s rows (a weight cut by rows) or ``down``'s columns (by
        columns)."""
        from ..weights.lora import LoraWeights, load_lora_file, merge_lora, parse_lora_state

        if isinstance(source, str):
            lora = load_lora_file(source)
        elif isinstance(source, LoraWeights):
            lora = source
        else:
            lora = parse_lora_state(source)
        if getattr(self.unet, "tp_cuts", None):
            lora = self._lora_for_cut_unet(lora)
        towers = self._towers()
        params = {name: m.state_dict() for name, m in towers.items()}
        merged, n, touched = merge_lora(params, lora, scale=scale, saved=self._lora_saved)
        for tower, leaves in touched.items():
            self._lora_saved.setdefault(tower, {}).update(leaves)
        text_changed = False
        for tower, sd in merged.items():
            changed = {k: v for k, v in sd.items() if v is not params[tower][k]}
            self._assign(towers[tower], changed)
            text_changed |= bool(changed) and tower != "unet"
        if text_changed:
            self.invalidate_encode_caches()
        return n

    def _lora_for_cut_unet(self, lora):
        """``lora`` with each UNet entry on a cut weight cut like it."""
        from ..parallel.mesh import cut_index, tp_of
        from ..weights.lora import LoraWeights

        rank, size, _ = tp_of(self.mesh)
        entries = dict(lora.towers.get("unet", {}))
        for name, (dim, full) in self.unet.tp_cuts.items():
            flat = name[:-len(".weight")].replace(".", "_")
            if not name.endswith(".weight") or flat not in entries:
                continue
            e, idx = entries[flat], cut_index(name, full, rank, size)
            entries[flat] = (dataclasses.replace(e, up=e.up.index_select(0, idx)) if dim == 0
                             else dataclasses.replace(e, down=e.down.index_select(1, idx)))
        return LoraWeights({**lora.towers, "unet": entries})

    def unload_loras(self) -> None:
        """Put back the exact pre-LoRA weights that :meth:`load_lora` saved,
        and drop the encode caches."""
        if not self._lora_saved:
            return
        towers = self._towers()
        for tower, saved in self._lora_saved.items():
            self._assign(towers[tower], saved)
        self._lora_saved = {}
        self.invalidate_encode_caches()

    def load_ip_adapter(self, source=None, image_encoder=None, num_tokens: int = 4,
                        scale: float = 1.0, image_embed_dim: int = 1024, seed: int = 0):
        """Attach an IP-Adapter (image prompts, Ye et al. 2023;
        ``pww_tpu/pipeline/pipeline.py:925-1064``). ``source``: a flat
        ``ip-adapter*.safetensors``/``.bin`` path, a raw state dict, a
        parsed ``(image_proj, sites)`` pair, or None for N(0, 0.02) weights
        from ``seed`` (``num_tokens`` tokens from ``image_embed_dim``-wide
        embeddings). A checkpoint with ``image_proj.latents`` is the plus
        adapter (a Resampler over the encoder's penultimate states).
        ``image_encoder``: a transformers image-encoder directory, a
        :class:`~pww_tpu_torch.models.clip_vision.CLIPVisionEncoder`, or a
        ``(CLIPVisionConfig, state dict)`` pair; without one, ``generate``
        takes precomputed embeddings. A second call replaces the adapter.
        Returns the pipeline."""
        from ..models.clip_vision import CLIPVisionEncoder, ImageProjection, Resampler
        from ..models.unet import UNet2DConditionModel
        from ..weights import ip_adapter as ipw

        cfg = self.config
        proj_state = sites_state = None
        plus = False
        if source is not None:
            if isinstance(source, str):
                proj_state, sites_state = ipw.load_ip_adapter_file(source)
            elif isinstance(source, tuple):
                proj_state, sites_state = source
            else:
                proj_state, sites_state = ipw.parse_ip_adapter_state(source)
            plus = ipw.is_plus_format(proj_state)
            if plus:
                rcfg = ipw.resampler_config(proj_state)
                if rcfg["output_dim"] != cfg.unet.cross_attention_dim:
                    raise ValueError(f"ip-adapter-plus output dim {rcfg['output_dim']} != "
                                     f"cross_attention_dim {cfg.unet.cross_attention_dim}")
                num_tokens = rcfg["num_queries"]
                image_embed_dim = proj_state["proj_in.weight"].shape[1]
            else:
                num_tokens = ipw.num_tokens_from_proj(proj_state, cfg.unet.cross_attention_dim)
                image_embed_dim = proj_state["proj.weight"].shape[1]
        unet_cfg = dataclasses.replace(cfg.unet, ip_adapter_tokens=num_tokens)
        with torch.device("meta"):
            unet = UNet2DConditionModel(unet_cfg)
            if plus:
                proj = Resampler(**rcfg, embedding_dim=image_embed_dim)
            else:
                proj = ImageProjection(cfg.unet.cross_attention_dim, num_tokens, image_embed_dim)
        unet_now = (self.unet.state_dict() if self.mesh is None
                    else full_state(self.unet, self.mesh))  # the whole weights on a mesh
        base = {k: v for k, v in unet_now.items() if not k.endswith(ipw.IP_LEAVES)}
        del unet_now
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        if sites_state is not None:
            unet_state = ipw.install_ip_adapter(base, unet.state_dict(), unet_cfg, sites_state)
        else:  # N(0, 0.02) in the new projections, in state-dict order
            unet_state = {k: base[k] if k in base else
                          torch.randn(ref.shape, generator=g, device=self.device).mul_(0.02)
                          for k, ref in unet.state_dict().items()}
        if proj_state is not None:
            proj_params = (ipw.resampler_params(proj_state) if plus
                           else ipw.image_proj_params(proj_state))
        else:
            proj_params = synthetic_state(proj, g, self.dtype)
        encoder = image_encoder
        if isinstance(image_encoder, str):
            encoder = ipw.load_image_encoder(image_encoder)
        if isinstance(encoder, tuple):
            vcfg, state = encoder
            with torch.device("meta"):
                module = CLIPVisionEncoder(vcfg)
            encoder = self._place(module, state)
        elif encoder is not None:
            encoder = encoder.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        self.unet = self._place(unet, unet_state)
        if self.mesh is not None:
            shard_params(self.unet, self.mesh)
        self.config = dataclasses.replace(cfg, unet=unet_cfg)
        self._ip = {"proj": self._place(proj, proj_params), "num_tokens": num_tokens,
                    "scale": scale, "image_encoder": encoder, "embed_dim": image_embed_dim,
                    "plus": plus}
        return self

    def _ip_for_call(self, image, n: int, scale=None) -> Optional[IpState]:
        """The call's IpState where an adapter is attached; an image without
        one raises (``pww_tpu/pipeline/pipeline.py:1868-1875``)."""
        if self.config.unet.ip_adapter_tokens is not None:
            return self._ip_state(image, n, scale)
        if image is not None:
            raise ValueError("ip_adapter_image given but no adapter attached: call "
                             "pipe.load_ip_adapter(...) first")
        return None

    def _ip_state(self, image, n: int, scale=None) -> IpState:
        """The 2N-row IpState [uncond*N, cond*N] (``pww_tpu/pipeline/
        pipeline.py:1066-1142``): the cond rows project the reference
        image's CLIP embedding (the plus adapter: its penultimate states);
        the uncond rows the zero embedding (plus: the zero image through the
        encoder). ``image`` is precomputed when it has a leading batch of 1,
        the embed width last and a float type ((1, D) standard, (1, L, D)
        plus); a raw (H, W, 3) image goes through the encoder."""
        from ..models.clip_vision import preprocess_clip_image

        d = self._ip
        plus, enc = d["plus"], d["image_encoder"]

        def encode(img):
            size = enc.config.image_size
            px = (torch.zeros((1, 3, size, size)) if img is None
                  else preprocess_clip_image(img, size))
            px = px.to(self.device)
            return enc(px, output="hidden_and_pooled")[0] if plus else enc(px)

        def precomputed(x) -> bool:
            if getattr(x, "ndim", None) != (3 if plus else 2):
                return False
            if x.shape[0] != 1 or x.shape[-1] != d["embed_dim"]:
                return False
            if isinstance(x, torch.Tensor):
                return x.is_floating_point()
            dt = np.dtype(x.dtype)
            return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"

        if hasattr(image, "ndim") and precomputed(image):
            emb = (image if isinstance(image, torch.Tensor)
                   else torch.from_numpy(np.asarray(image, np.float32))).to(self.device)
            emb_uncond = encode(None) if plus and enc is not None else torch.zeros_like(emb)
        elif image is None and enc is None:
            emb = torch.zeros((1, 1, d["embed_dim"]) if plus else (1, d["embed_dim"]),
                              device=self.device)
            emb_uncond = emb
        elif enc is None:
            raise ValueError("no image encoder attached: load_ip_adapter(..., image_encoder="
                             "<dir>) or pass precomputed image embeddings ((1, D) standard / "
                             "(1, L, D) plus)")
        else:
            emb = encode(image)
            emb_uncond = encode(None) if plus else torch.zeros_like(emb)
        proj = d["proj"]
        cond, uncond = proj(emb.float()), proj(emb_uncond.float())
        tokens = torch.cat([uncond.expand(n, -1, -1), cond.expand(n, -1, -1)])
        return IpState(tokens, float(d["scale"] if scale is None else scale))

    def _control_residuals(self, control, lat: torch.Tensor, t,
                           text_states: torch.Tensor, pww: Optional[PwwState],
                           added_cond: Optional[Dict] = None):
        """Every attached ControlNet on its own (hint, scale), the residuals
        summed in order (``pww_tpu/pipeline/pipeline.py:47-70``); an SDXL
        net takes the rows' ``added_cond``."""
        down = mid = None
        for net, hint, scale in control:
            d, m = net(lat, t, text_states, hint, pww, scale, added_cond)
            if down is None:
                down, mid = list(d), m
            else:
                down = [a + b for a, b in zip(down, d)]
                mid = mid + m
        return down, mid

    # -- stages ----------------------------------------------------------------
    def encode_text(self, ids: torch.Tensor, ids2: Optional[torch.Tensor] = None,
                    clip_skip: int = 0):
        """Text states (B, 77, D); for SDXL ``(text_states, pooled)``: the
        refiner's one tower, or the base's two towers' penultimate states
        concatenated and the second tower's pooled vector (``ids2``, the
        second tokenizer's, default ``ids``). ``clip_skip=k``: the states k
        layers early in every tower (the pooled vector from the full one)."""
        if self.config.xl_refiner:
            return self.clip(ids, output="penultimate_and_pooled", skip_layers=clip_skip)
        if self.clip2 is None:
            return self.clip(ids, skip_layers=clip_skip)
        h2, pooled = self.clip2(ids if ids2 is None else ids2,
                                output="penultimate_and_pooled", skip_layers=clip_skip)
        h1 = self.clip(ids, output="penultimate", skip_layers=clip_skip)
        return torch.cat([h1, h2], dim=-1), pooled

    def invalidate_encode_caches(self) -> None:
        """Drop the cached encodes and text states after an encoder weight
        change. Takes ``_encode_lock``, so that an encode running on another
        thread inserts its stale entry before the clear, not after it."""
        with self._encode_lock:
            self._text_cache.clear()
            self._encode_cache.clear()

    @staticmethod
    def _encode_cache_key(prompt, color_map, color_context, negative_prompt,
                          weight_function, prompt_weighting, clip_skip, long_prompts):
        """A hashable key for one encode, or None (no caching). The weight
        function takes part as the object: a frozen ``WeightFunction`` by
        value, a callable by identity, kept alive inside the key."""
        try:
            cm_key = None
            if color_map is not None:
                arr = np.ascontiguousarray(color_map)
                cm_key = (arr.shape, str(arr.dtype), hashlib.sha1(arr.tobytes()).hexdigest())
            ctx_key = tuple(sorted((repr(k), str(v)) for k, v in (color_context or {}).items()))
            key = (prompt, negative_prompt, cm_key, ctx_key, weight_function,
                   bool(prompt_weighting), int(clip_skip), bool(long_prompts))
            hash(key)
            return key
        except Exception:  # unhashable inputs: no caching
            return None

    def encode_inputs(self, prompt: str, color_map: Optional[np.ndarray],
                      color_context: Dict, negative_prompt: str = "",
                      weight_function: Optional[AnyWeightFunction] = None,
                      prompt_weighting: bool = False, clip_skip: int = 0,
                      long_prompts: bool = False) -> EncodedInputs:
        """The encode prologue through an LRU cache of 32 entries; a hit
        replays the warnings the encode gave (the reference warns on every
        call). The result is treated as immutable downstream."""
        key = self._encode_cache_key(prompt, color_map, color_context, negative_prompt,
                                     weight_function, prompt_weighting, clip_skip,
                                     long_prompts)
        with self._encode_lock:
            if key is not None and key in self._encode_cache:
                enc, warns = self._encode_cache.pop(key)
                self._encode_cache[key] = (enc, warns)  # most recent last
            else:
                with warnings.catch_warnings(record=True) as rec:
                    warnings.simplefilter("always")
                    enc = self._encode_inputs_uncached(
                        prompt, color_map, color_context, negative_prompt, weight_function,
                        prompt_weighting, clip_skip, long_prompts)
                warns = [(str(r.message), r.category) for r in rec]
                if key is not None:
                    if len(self._encode_cache) >= 32:
                        self._encode_cache.pop(next(iter(self._encode_cache)))
                    self._encode_cache[key] = (enc, warns)
        for msg, cat in warns:
            warnings.warn(msg, cat, stacklevel=2)
        return enc

    def _encode_inputs_uncached(self, prompt, color_map, color_context, negative_prompt="",
                                weight_function=None, prompt_weighting=False, clip_skip=0,
                                long_prompts=False) -> EncodedInputs:
        cfg = self.config
        return encode_text_color_inputs(
            self.encode_text, self.tokenizer, color_map, color_context,
            prompt, negative_prompt, weight_function, device=self.device,
            tokenizer_2=self.tokenizer_2,
            zero_empty_negative=cfg.needs_pooled and cfg.force_zeros_for_empty_prompt,
            text_cache=self._text_cache, prompt_weighting=prompt_weighting,
            clip_skip=clip_skip, long_prompts=long_prompts,
            dual_split_dim=cfg.clip.hidden_size if cfg.is_xl else None,
        )

    @staticmethod
    def _tile_cfg(enc: EncodedInputs, n: int):
        """The (2, ...) CFG pair → (2N, ...) rows [uncond*N, cond*N]:
        (text states, PwW state, pooled vector)."""
        if n == 1:
            return enc.text_states, enc.pww, enc.pooled

        def tile(x):
            return torch.cat([x[:1].expand(n, *x.shape[1:]), x[1:].expand(n, *x.shape[1:])])

        pww = dataclasses.replace(
            enc.pww, weights={k: tile(v) for k, v in enc.pww.weights.items()},
            weight_orig=tile(enc.pww.weight_orig))
        return tile(enc.text_states), pww, None if enc.pooled is None else tile(enc.pooled)

    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) f32 in [-1, 1] → (B, 2·latent, h, w) f32 moments."""
        x = torch.from_numpy(np.ascontiguousarray(image)).permute(0, 3, 1, 2)
        x = x.to(device=self.device, dtype=self.dtype).contiguous()
        return self.vae.encode_moments(x).float()

    def denoise(self, latents, text_states, pww: PwwState, schedule, guidance_scale,
                t_start: int = 0, extra: Optional[torch.Tensor] = None, blend=None,
                seeds: Sequence[int] = (0,), control=None, adapter=None, added_cond=None,
                t_end: Optional[int] = None, callback: Optional[Callable] = None,
                callback_steps: int = 1, cache_interval: int = 1, tome_ratio: float = 0.0,
                freeu=None, sag_scale: float = 0.0, conds: Optional[Dict] = None,
                ip: Optional[IpState] = None, shard: Optional[BatchRows] = None):
        """The scheduler's loop from visit ``t_start`` to ``t_end`` (default:
        the last); latents (N, C, h, w) f32 in and out.

        Cond and uncond go through one batched UNet call per visit; a custom
        weight function takes two, the uncond one without any bias (the
        reference's semantics, ``pww_tpu/pipeline/pipeline.py:114-151``).
        Where :func:`.graphs.engages` holds (the card, no autograd, the
        batched path without ControlNet, T2I, DeepCache, SAG, ToMe, FreeU,
        prompt editing or a mesh), each visit signature's first UNet call
        runs eagerly, its second is captured as a CUDA graph and every later
        one replays it (:attr:`unet_graphs`).
        ``extra`` (N, E, h, w) joins the UNet input channels (9-channel
        inpaint). ``blend`` = (mask, init, noise) is the legacy masked blend:
        before each UNet call the unmasked latents are reset to the init's
        trajectory at that step, and restored exactly at the end. The UNet's
        output is converted to ε per CFG half (v-prediction), and the
        stochastic kinds draw their step noise from each seed in ``seeds``
        (:func:`~pww_tpu_torch.schedulers.schedules.step_noise`), which
        split the N rows evenly (one seed for ``num_samples``, one a request
        for ``generate_batch``).

        ``callback(visit, float(timestep), latents)`` runs after every
        ``callback_steps`` visits counted from ``t_start`` and after the
        last, with the loop's (N, h, w, C) f32 latents on the device, before
        the legacy blend's final restore (``pww_tpu/pipeline/pipeline.py:
        2110-2130``).

        ``control``: (ControlNet, (N, 3, H, W) hint, scale) per attached net;
        on the batched path each net sees the hint twice and the batched PwW
        state, on the split path it runs per half, without any bias on the
        uncond one. ``adapter``: the T2I-Adapter's f32 features, N-batched.
        ``added_cond``: SDXL's pooled text and time_ids and an LCM UNet's
        ``timestep_cond``, 2N rows [uncond*N, cond*N], each CFG half taking
        its own on the split path.

        The extras (``pww_tpu/pipeline/pipeline.py:165-414``):
        ``cache_interval`` > 1 is DeepCache, a full visit (which caches the
        deep feature) every ``cache_interval`` visits counted from
        ``t_start`` and the shallow pass between; ``tome_ratio`` and
        ``freeu`` go to every UNet call; ``sag_scale`` > 0 is SAG: the uncond
        rows' mid-block self-attention marks the keys that receive more
        than their share (summed over queries, averaged over heads, > 1),
        the uncond x0 is blurred there (9 taps, σ 1), re-noised with the
        uncond ε, and one more uncond-only pass on it pushes the guided ε
        away by ``sag_scale``·(ε_u − ε_degraded). ``conds``: prompt editing,
        {visit: (text_states, pww, added_cond)} for every visit, replacing
        the three arguments. ``ip``: the IP-Adapter's 2N-row tokens and
        scale, to every UNet call: all rows to the batched call and both
        DeepCache passes, each CFG half's rows on the split path, the uncond
        rows to SAG's degraded pass; the ControlNet takes none
        (``pww_tpu/pipeline/pipeline.py:60-63, 147-148, 291, 361-369``).

        ``shard``: on a mesh, this rank's cut of the N samples
        (:class:`BatchRows`) or of the image's rows
        (:class:`~pww_tpu_torch.parallel.spatial.Spatial`); default: no
        mesh. Every input comes whole and is cut here, the step noise is
        drawn whole and cut, and the callback sees the gathered latents;
        the loop returns this rank's rows. Under a spatial cut the
        ControlNets run whole on the gathered latents and SAG blurs the
        gathered x0.
        """
        if shard is None:
            shard = BatchRows(None, latents.shape[0])
        with shard.sites():
            return self._denoise(latents, text_states, pww, schedule, guidance_scale, t_start,
                                 extra, blend, seeds, control, adapter, added_cond, t_end,
                                 callback, callback_steps, cache_interval, tome_ratio, freeu,
                                 sag_scale, conds, ip, shard)

    def _denoise(self, latents, text_states, pww, schedule, guidance_scale, t_start, extra,
                 blend, seeds, control, adapter, added_cond, t_end, callback, callback_steps,
                 cache_interval, tome_ratio, freeu, sag_scale, conds, ip, shard):
        latents, extra = shard.rows(latents), None if extra is None else shard.rows(extra)
        blend = None if blend is None else tuple(shard.rows(x) for x in blend)
        control = [(net, shard.hint(h), sc) for net, h, sc in control or ()]
        adapter = None if adapter is None else [shard.rows(a) for a in adapter]
        text_states, pww, added_cond = (shard.cfg(text_states), shard.pww(pww),
                                        shard.added(added_cond))
        ip = None if ip is None else IpState(shard.cfg(ip.tokens), ip.scale)
        split = isinstance(pww.weight_fn, CustomWeightFunction)
        sag = sag_scale > 0
        if blend is not None and sag:
            raise ValueError("sag_scale is not supported with legacy masked-blend inpainting")
        if blend is not None and cache_interval > 1:
            raise ValueError("cache_interval > 1 is not supported with legacy masked-blend "
                             "inpainting")
        if sag:
            if split:
                raise ValueError("sag_scale requires the batched CFG path (no custom weight "
                                 "functions)")
            if control or adapter is not None:
                raise ValueError("sag_scale is not supported with ControlNet or T2I-Adapter")
            if extra is not None:
                raise ValueError("sag_scale is not supported with inpainting (9-channel UNets)")
            if cache_interval > 1:
                raise ValueError("sag_scale is not supported with DeepCache")
            if callback is not None:
                raise ValueError("sag_scale is not supported with per-step callbacks")
        if cache_interval > 1:
            if control:
                raise ValueError("cache_interval > 1 is not supported with ControlNet")
            if adapter is not None:
                raise ValueError("cache_interval > 1 is not supported with a T2I-Adapter (the "
                                 "deep-trunk features the cache reuses include the adapter "
                                 "residuals of the cached step)")
            if split:
                raise ValueError("cache_interval > 1 requires the batched CFG path; custom "
                                 "weight functions run split CFG and cannot deep-cache")
        n = latents.shape[0]
        lat = latents.float()
        prediction_type = self.config.unet.prediction_type
        extras = dict(tome_ratio=float(tome_ratio), freeu=freeu)
        state = schedule.init_state(lat.shape, self.device)
        t_stop = schedule.num_steps if t_end is None else t_end
        graphs = visit_graphs.engages(
            self.device, split=split, control=control, adapter=adapter,
            cache_interval=cache_interval, sag_scale=sag_scale, conds=conds,
            tome_ratio=tome_ratio, freeu=freeu,
            whole=type(shard) is BatchRows and shard.mesh is None)
        session = None  # the call's visits through the UNet's CUDA graphs
        if not split:  # both CFG halves in one call: hints and features twice
            control = [(net, torch.cat([h, h]), sc) for net, h, sc in control or ()]
            adapter = None if adapter is None else [torch.cat([a, a]) for a in adapter]
        feature = None  # DeepCache's deep feature, from the last full visit
        for i in range(t_start, t_stop):
            if not graphs:
                self.unet_graphs.count_eager()
            if conds is not None:
                text_states, pww, added_cond = conds[i]
                text_states, pww, added_cond = (shard.cfg(text_states), shard.pww(pww),
                                                shard.added(added_cond))
            if blend is not None:
                mask, init, noise = blend
                lat = schedule.add_noise(init, noise, i) * (1.0 - mask) + lat * mask
            lat_c = schedule.scale_model_input(lat, i).to(self.dtype)
            t, sigma = schedule.timesteps[i], schedule.sigma(i)
            pww_t = pww.with_sigma(sigma)
            probs = [] if sag else None
            if split:
                cond_pww = dataclasses.replace(
                    pww_t, weights={k: v[n:] for k, v in pww_t.weights.items()},
                    weight_orig=None if pww_t.weight_orig is None else pww_t.weight_orig[n:])
                lat_in = lat_c if extra is None else torch.cat([lat_c, extra], dim=1)
                outs = []
                for half, p in ((slice(0, n), None), (slice(n, 2 * n), cond_pww)):
                    ac = None if added_cond is None else {k: v[half]
                                                          for k, v in added_cond.items()}
                    down = mid = None
                    if control:
                        down, mid = shard.whole(
                            lambda x: self._control_residuals(control, x, t,
                                                              text_states[half], p, ac), lat_c)
                    outs.append(self.unet(lat_in, t, text_states[half], p, down, mid,
                                          adapter, ac, ip=None if ip is None else ip.rows(half),
                                          **extras).float())
                out_u, out_c = outs
            else:
                lat2 = torch.cat([lat_c, lat_c])
                down = mid = None
                if control:
                    down, mid = shard.whole(
                        lambda x: self._control_residuals(control, x, t, text_states, pww_t,
                                                          added_cond), lat2)
                if extra is not None:
                    lat2 = torch.cat([lat2, torch.cat([extra, extra])], dim=1)
                args = (lat2, t, text_states, pww_t, down, mid, adapter, added_cond)
                if cache_interval > 1 and (i - t_start) % cache_interval == 0:
                    eps2, feature = self.unet(*args, cache_mode="collect", ip=ip, **extras)
                elif cache_interval > 1:
                    eps2 = self.unet(*args, cache_mode="use", cached_feature=feature, ip=ip,
                                     **extras)
                elif graphs:
                    visit = {"lat": lat2, "t": t, "sigma": sigma}
                    if session is None:
                        session = self._visit_session(text_states, pww, added_cond, ip, visit)
                    eps2 = session.visit(visit)
                else:
                    eps2 = self.unet(*args, sag_probs=probs, ip=ip, **extras)
                out_u, out_c = eps2[:n].float(), eps2[n:].float()
            eps_u = schedule.to_epsilon(out_u, lat, i, prediction_type)
            eps_c = schedule.to_epsilon(out_c, lat, i, prediction_type)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            if sag:
                eps = eps + sag_scale * (eps_u - self._sag_degraded_eps(
                    lat, eps_u, probs[0][:n], i, schedule, t, text_states[:n], pww_t,
                    added_cond, extras, None if ip is None else ip.rows(slice(0, n)), shard))
            noise = (shard.rows(step_noise(seeds, i, shard.whole_shape(lat), self.device))
                     if schedule.needs_noise else None)
            lat, state = schedule.step(eps, i, lat, state, noise)
            if callback is not None and ((i + 1 - t_start) % callback_steps == 0
                                         or i + 1 == t_stop):
                callback(i, float(schedule.timesteps[i]),
                         shard.gather(lat).permute(0, 2, 3, 1).contiguous())
        if blend is not None:
            mask, init, _ = blend
            lat = init * (1.0 - mask) + lat * mask
        return lat

    def _visit_session(self, text_states, pww: PwwState, added_cond, ip, visit):
        """The CUDA-graph session of a call's UNet visits on the batched CFG
        path (:mod:`.graphs`): the call's constant inputs (text states, the
        PwW pyramid, the added conditions, the IP tokens) and the UNet visit
        on them and on ``visit``'s latents, timestep and sigma. The
        full-resolution PwW map joins them only where some level's size is
        not a pyramid key, since no site reads it otherwise."""
        h, w = visit["lat"].shape[-2:]
        levels = len(self.config.unet.block_out_channels)
        keys, added_keys = list(pww.weights), list(added_cond or ())
        call = {"text": text_states, **{f"w{k}": pww.weights[k] for k in keys},
                **{f"added.{k}": added_cond[k] for k in added_keys}}
        if pww.weight_orig is not None and any(
                (h // 2 ** i) * (w // 2 ** i) not in pww.weights for i in range(levels)):
            call["orig"] = pww.weight_orig
        if ip is not None:
            call["ip"] = ip.tokens
        unet, weight_fn, ip_scale = self.unet, pww.weight_fn, None if ip is None else ip.scale

        def run(x):
            p = PwwState({k: x[f"w{k}"] for k in keys}, x.get("orig"), x["sigma"], weight_fn)
            added = None if added_cond is None else {k: x[f"added.{k}"] for k in added_keys}
            return unet(x["lat"], x["t"], x["text"], p, None, None, None, added,
                        ip=None if ip is None else IpState(x["ip"], ip_scale))

        return self.unet_graphs.session(unet, run, call, visit, weight_fn, ip_scale)

    def _sag_degraded_eps(self, lat, eps_u, probs_u, i, schedule, t, text_u, pww_t,
                          added_cond, extras, ip_u=None, shard=None):
        """SAG's uncond ε on the degraded latents
        (``pww_tpu/pipeline/pipeline.py:263-294``): ``probs_u`` (N, H, L, L)
        are the uncond rows' mid-block probabilities, ``ip_u`` the uncond
        rows' IP-Adapter tokens. Under a spatial cut the mask and the blur
        take the gathered latents, and the degraded ones are cut again."""
        def degrade(lat, eps_u):
            n, _, h_lat, w_lat = lat.shape
            down = 2 ** (len(self.config.unet.block_out_channels) - 1)
            # an integer upscale, where torch's and jax.image.resize's nearest agree
            mask = resize_nearest(sag_mask(probs_u).reshape(n, 1, h_lat // down, w_lat // down)
                                  .float(), h_lat, w_lat)
            x0_u = schedule.pred_x0(eps_u, lat, i)
            degraded = gaussian_blur(x0_u, 9, 1.0) * mask + x0_u * (1.0 - mask)
            return schedule.add_noise(degraded, eps_u, i)

        n = lat.shape[0]
        deg_lat = degrade(lat, eps_u) if shard is None else shard.whole(degrade, lat, eps_u)
        deg_in = schedule.scale_model_input(deg_lat, i).to(self.dtype)
        pww_u = dataclasses.replace(
            pww_t, weights={k: v[:n] for k, v in pww_t.weights.items()},
            weight_orig=None if pww_t.weight_orig is None else pww_t.weight_orig[:n])
        ac = None if added_cond is None else {k: v[:n] for k, v in added_cond.items()}
        out = self.unet(deg_in, t, text_u, pww_u, None, None, None, ac, sag_probs=[],
                        ip=ip_u, **extras).float()
        return schedule.to_epsilon(out, deg_lat, i, self.config.unet.prediction_type)

    def decode_uint8_device(self, latents: torch.Tensor, shard=None) -> torch.Tensor:
        """Latents (N, C, h, w) → contiguous (N, H, W, 3) uint8 on the
        pipeline's device (reference `_pil_from_latents`). ``shard``: on a
        mesh, this rank's cut (:meth:`denoise`'s); the decode runs on it and
        its result is gathered."""
        with contextlib.nullcontext() if shard is None else shard.sites():
            img = self.vae.decode(latents / self.config.vae.scaling_factor)
        if shard is not None:
            img = shard.gather(img)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        img = torch.round(img * 255.0).to(torch.uint8)
        return img.permute(0, 2, 3, 1).contiguous()

    @property
    def timings(self) -> Dict[str, float]:
        """The last profiled seconds of each phase, from :attr:`timers`."""
        return {name: times[-1] for name, times in self.timers.times.items()}

    def _phase(self, name, t0):
        if self.profile:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timers.record(name, time.perf_counter() - t0)
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
        init_image=None,  # img2img when set
        init_latents=None,  # img2img from scaled (N, h, w, C) latents, no VAE encode
        denoising_end: Optional[float] = None,  # run the first fraction of the trajectory
        denoising_start: Optional[float] = None,  # resume init_latents at this fraction
        strength: float = 0.5,
        mask_image=None,  # inpaint when set (with init_image)
        mask_blur: float = 0.0,  # gaussian sigma (px) feathering the mask
        masked_content: str = "original",  # original | fill | latent_noise |
        #   latent_nothing (latent_* need a 4-channel UNet)
        inpaint_full_res: bool = False,  # A1111 "inpaint area: only masked"
        inpaint_full_res_padding: int = 32,  # context px around the mask
        control_image=None,  # ControlNet hint(s), (H, W, 3) uint8 (load_controlnet first)
        controlnet_conditioning_scale=1.0,  # a float, or one per stacked ControlNet
        adapter_image=None,  # T2I-Adapter hint (load_t2i_adapter first)
        adapter_conditioning_scale: float = 1.0,
        callback: Optional[Callable] = None,  # callback(visit, timestep, latents)
        callback_steps: int = 1,
        original_size: Optional[Tuple[int, int]] = None,  # SDXL micro-conditioning
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        aesthetic_score: float = 6.0,  # SDXL-refiner micro-conditioning
        negative_aesthetic_score: float = 2.5,
        prompt_weighting: bool = False,  # A1111 (word:1.2) emphasis syntax
        clip_skip: int = 0,  # text states k layers early (A1111 CLIP skip k + 1)
        long_prompts: bool = False,  # >77-token windowed prompts (A1111)
        num_samples: int = 1,
        noise_mode: str = "jax",
        vae_sample_mode: str = "sample",  # "mean" = the posterior mean
        output_type: str = "pil",
        latents=None,  # txt2img: caller-drawn initial noise, (N, h, w, C) NHWC
        return_latents: bool = False,
        cache_interval: int = 1,  # DeepCache: a full UNet visit every k visits
        tome_ratio: float = 0.0,  # ToMe: the share of tokens merged at 64² sites
        freeu=None,  # FreeU: True (the family's defaults) or (b1, b2, s1, s2)
        sag_scale: float = 0.0,  # Self-Attention Guidance strength (0 = off)
        prompt_editing: bool = False,  # A1111 [from:to:when] and [a|b] schedules
        ip_adapter_image=None,  # reference image or embeddings (load_ip_adapter first)
        ip_adapter_scale: Optional[float] = None,  # default: load_ip_adapter's scale
        rng=None,  # img2img/inpaint: the (2,) uint32 key split for the VAE sample
        sharding: str = "batch",  # on a mesh: "batch" (samples over dp) | "spatial" (rows)
        **unported,
    ):
        """txt2img, img2img and inpaint with paint-with-words. Returns PIL
        image(s), a (N, H, W, 3) uint8 array (``output_type="np"``), the
        un-fetched (N, H, W, 3) uint8 tensor on the pipeline's device
        (``output_type="device"``), or with ``return_latents`` the final
        (N, h, w, 4) f32 latents (NHWC).

        ``latents``: txt2img's initial noise, drawn by the caller, in the
        layout ``return_latents`` gives, (``num_samples``, h, w, C); it is
        scaled by the schedule's ``init_noise_sigma`` and takes no regional
        seeding (``pww_tpu/pipeline/pipeline.py:1621-1628``). With
        ``init_image`` or ``init_latents`` it is ignored, as in the JAX
        pipeline.

        ``control_image``: one hint per attached ControlNet (a single one is
        shared by all), RGB in [0, 255] at the processing resolution;
        ``adapter_image``: the T2I-Adapter's hint, RGB or, for a 1-channel
        adapter, gray (an RGB one is averaged).

        ``callback(visit, float(timestep), latents)`` runs every
        ``callback_steps`` visits and after the last, with the (N, h, w, C)
        f32 latents on the device. ``prompt_weighting``, ``long_prompts``
        and ``clip_skip``: see :func:`~pww_tpu_torch.conditioning.encode.
        encode_text_color_inputs`.

        SDXL: ``original_size`` and ``target_size`` default to the render
        size; the refiner's uncond half takes ``negative_aesthetic_score``.
        ``denoising_end=f`` stops after the visits whose timestep is at or
        above ``round(T - f·T)`` (T train timesteps), and ``init_latents``
        with ``denoising_start=f`` starts at the first visit below it,
        without re-noising (diffusers' ensemble of expert denoisers;
        ``pww_tpu/pipeline/pipeline.py:1523-1611, 1931``). ``init_latents``
        without ``denoising_start`` re-noises them at ``strength``.

        The extras: ``cache_interval``, ``tome_ratio``, ``freeu`` and
        ``sag_scale`` as :meth:`denoise` takes them; an LCM-distilled UNet
        takes ``guidance_scale`` as its embedded input and combines CFG at
        1.0. ``prompt_editing``: a prompt or negative prompt with A1111
        ``[from:to:when]`` / ``[a|b]`` constructs is encoded once per
        distinct rendering, and each visit takes its step's conditioning
        (the first rendering sets the size, the regions and the seeding).

        ``ip_adapter_image``: with an IP-Adapter attached, a PIL image or
        (H, W, 3) array, or precomputed embeddings ((1, D) standard, (1, L,
        D) plus; :meth:`_ip_state`), None for the zero image;
        ``ip_adapter_scale`` overrides the adapter's scale for the call."""
        cfg = self.config
        freeu = freeu_params(freeu, cfg.is_xl)
        tome_ratio = float(tome_ratio)
        if callback is not None:
            if denoising_end is not None or denoising_start is not None:
                raise ValueError("denoising_end/denoising_start are not supported with "
                                 "per-step callbacks")
            if cache_interval > 1:
                raise ValueError("cache_interval > 1 is not supported with per-step "
                                 "callbacks")
            if int(callback_steps) < 1:
                raise ValueError(f"callback_steps must be >= 1, got {callback_steps}")
        refuse_unported("generate", unported)
        if sharding not in ("batch", "spatial"):
            raise ValueError(f'sharding must be "batch" or "spatial", got {sharding!r}')
        spatial_call = sharding == "spatial" and self.mesh is not None
        if output_type not in ("pil", "np", "device"):
            raise ValueError(f"output_type must be 'pil', 'np' or 'device', got "
                             f"{output_type!r}")
        if output_type == "device" and (return_latents or callback is not None
                                        or inpaint_full_res):
            raise ValueError('output_type="device" returns the decoded images as they '
                             "are: no return_latents/callback/inpaint_full_res (those "
                             "need host post-processing)")
        check_noise_mode(noise_mode)
        t0 = time.perf_counter()
        color_map = _to_numpy_image(color_map_image)
        ifr_state = None
        if inpaint_full_res:
            if mask_image is None or init_image is None:
                raise ValueError("inpaint_full_res requires init_image and mask_image")
            if return_latents:
                raise ValueError("inpaint_full_res pastes decoded pixels back into the "
                                 "init image; return_latents is unsupported")
            (init_image, mask_image, color_map, control_image, adapter_image,
             ifr_state) = self._crop_for_full_res(
                init_image, mask_image, color_map, control_image, adapter_image,
                float(mask_blur), int(inpaint_full_res_padding))
            mask_blur = 0.0  # the crop's mask is feathered already
        edit_sched = None
        if prompt_editing:
            from ..conditioning.prompt_editing import combined_schedule, has_editing

            if has_editing(prompt) or has_editing(negative_prompt):
                edit_sched = combined_schedule(prompt, negative_prompt, num_inference_steps)
                # the first rendering sets everything outside the loop
                prompt, negative_prompt = edit_sched[0][1], edit_sched[0][2]
        enc = self.encode_inputs(prompt, color_map, color_context or {},
                                 negative_prompt, weight_function,
                                 prompt_weighting=prompt_weighting, clip_skip=clip_skip,
                                 long_prompts=long_prompts)
        sf = cfg.vae.scale_factor
        n = num_samples
        schedule = self.scheduler.set_timesteps(num_inference_steps, self.device)

        inpaint = mask_image is not None
        if inpaint and init_image is None:
            raise ValueError("inpainting requires init_image alongside mask_image")
        check_masked_content(masked_content, mask_blur, inpaint)
        # a 4-channel UNet inpaints by the legacy masked blend, a 9-channel
        # one by its mask and masked-image input channels
        legacy_inpaint = inpaint and cfg.unet.in_channels == cfg.vae.latent_channels
        if masked_content in ("latent_noise", "latent_nothing") and not legacy_inpaint:
            raise ValueError(f"masked_content={masked_content!r} applies to the legacy "
                             "masked-blend path (4-channel checkpoints); use 'original' "
                             "or 'fill' with a 9-channel inpainting UNet")
        if init_latents is not None and (init_image is not None or inpaint):
            raise ValueError("init_latents is exclusive with init_image/mask_image")
        if denoising_start is not None and init_latents is None:
            raise ValueError("denoising_start requires init_latents (the partially "
                             "denoised trajectory to resume)")
        for frac, name in ((denoising_end, "denoising_end"),
                           (denoising_start, "denoising_start")):
            if frac is not None and not 0.0 < frac < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {frac}")
        if legacy_inpaint and denoising_end is not None:
            raise ValueError("denoising_end is not supported with legacy masked-blend "
                             "inpainting: the final exact restore assumes the trajectory "
                             "ran to completion, and a refiner continuation cannot carry "
                             "the mask")
        if color_map is not None:
            height, width = enc.height, enc.width
        elif init_latents is not None:
            height, width = init_latents.shape[1] * sf, init_latents.shape[2] * sf
        else:
            height, width = _image_hw(init_image, default=(512, 512))

        def steps_at_or_above(frac: float) -> int:
            # the experts' cutoff on the train timesteps (pww_tpu/pipeline/
            # pipeline.py:1582): visits with t >= round(T - frac·T) are the
            # first expert's
            n_train = cfg.scheduler.num_train_timesteps
            cutoff = int(round(n_train - frac * n_train))
            return int((schedule.timesteps.cpu() >= cutoff).sum())

        t_start, extra, blend = 0, None, None
        if init_latents is not None:
            init_lat = torch.as_tensor(init_latents).to(torch.float32)
            want_shape = (n, height // sf, width // sf, cfg.vae.latent_channels)
            if tuple(init_lat.shape) != want_shape:
                raise ValueError(f"init_latents shape {tuple(init_lat.shape)} != {want_shape}")
            init_lat = init_lat.permute(0, 3, 1, 2).contiguous().to(self.device)
            if denoising_start is not None:
                t_start = truncation_checked(steps_at_or_above(denoising_start), schedule)
            else:
                t_start = self._t_start(num_inference_steps, strength, schedule)
            if denoising_start is not None:  # the same trajectory: no re-noising
                lat = init_lat
            else:
                noise = make_noise(seed, tuple(init_lat.shape), noise_mode, self.device)
                lat = schedule.add_noise(init_lat, noise, t_start)
        elif init_image is None:
            if latents is not None:
                lat = torch.as_tensor(latents)
                want_shape = (n, height // sf, width // sf, cfg.vae.latent_channels)
                if tuple(lat.shape) != want_shape:
                    raise ValueError(f"latents shape {tuple(lat.shape)} != {want_shape}")
                lat = lat.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()
            else:
                shape = (n, cfg.vae.latent_channels, height // sf, width // sf)
                lat = make_noise(seed, shape, noise_mode, self.device)
                lat = regional_seed_latents(lat, enc.regions, noise_mode)
            lat = lat * schedule.init_noise_sigma
        else:
            t_start = self._t_start(num_inference_steps, strength, schedule)
            lat, extra, blend = self._image_latents(
                preprocess_image(init_image), mask_image, mask_blur, masked_content, seed, n,
                schedule, t_start, noise_mode, vae_sample_mode, legacy_inpaint, rng)

        proc_hw = (lat.shape[2] * sf, lat.shape[3] * sf)
        control = None
        if control_image is not None:
            if extra is not None:
                # pww_tpu feeds its ControlNet (conv_in built for the UNet's
                # in_channels) the 4-channel latents, and cannot run this
                raise ValueError("a ControlNet on a 9-channel inpainting UNet is not "
                                 "supported (the reference cannot run it: ROADMAP C.7)")
            control = self._control_inputs(control_image, controlnet_conditioning_scale,
                                           proc_hw, n)
        adapter = None
        if adapter_image is not None:
            if self.t2i_adapter is None:
                raise ValueError("adapter_image given but no T2I-Adapter loaded; call "
                                 "pipeline.load_t2i_adapter(...) first")
            arr = _load_hint(adapter_image, self.t2i_adapter.in_channels, proc_hw,
                             "adapter_image")
            hint = torch.from_numpy(arr).permute(2, 0, 1)[None].expand(n, -1, -1, -1)
            # run once, outside the loop; f32 features times an f32 scale
            # (pww_tpu/pipeline/pipeline.py:1798-1826)
            adapter = [f.float() * float(np.float32(adapter_conditioning_scale))
                       for f in self.t2i_adapter(hint.to(self.device))]

        text_states, pww, pooled = self._tile_cfg(enc, n)  # rows [uncond*N, cond*N]
        added_cond = None
        if cfg.needs_pooled:
            time_ids = micro_time_ids(
                cfg.xl_refiner, [tuple(original_size or (height, width))] * n,
                [tuple(crops_coords_top_left)] * n, [tuple(target_size or (height, width))] * n,
                aesthetic_score, negative_aesthetic_score, self.device)
            added_cond = {"text_embeds": pooled.float(), "time_ids": time_ids}
        added_cond, guidance_scale = self._lcm_guidance(added_cond, guidance_scale, n)
        ip = self._ip_for_call(ip_adapter_image, n, ip_adapter_scale)
        t_end = None if denoising_end is None else steps_at_or_above(denoising_end)
        if edit_sched is not None and len(edit_sched) == 1:
            edit_sched = None  # a constant schedule: the plain path
        conds = None
        if edit_sched is not None:
            if cache_interval > 1:
                raise ValueError("prompt_editing is not supported with DeepCache "
                                 "(cache_interval > 1): the cached trunk would go stale "
                                 "at a switch point")
            if sag_scale > 0:
                raise ValueError("prompt_editing is not supported with sag_scale")
            if denoising_end is not None or denoising_start is not None:
                raise ValueError("prompt_editing is not supported with "
                                 "denoising_end/denoising_start")
            if output_type == "device":
                raise ValueError('output_type="device" is not supported with '
                                 "prompt_editing")
            conds = self._edit_conds(
                edit_sched, schedule, t_start, n, added_cond,
                dict(color_map=color_map, color_context=color_context or {},
                     weight_function=weight_function, prompt_weighting=prompt_weighting,
                     clip_skip=clip_skip, long_prompts=long_prompts))
        shard = (Spatial(self.mesh, n, lat.shape[2], lat.shape[3]) if spatial_call
                 else BatchRows(self.mesh, n))
        t0 = self._phase("encode", t0)
        lat = self.denoise(lat, text_states, pww, schedule, float(guidance_scale),
                           t_start=t_start, extra=extra, blend=blend, seeds=[seed],
                           control=control, adapter=adapter, added_cond=added_cond,
                           t_end=t_end, callback=callback, callback_steps=int(callback_steps),
                           cache_interval=int(cache_interval), tome_ratio=tome_ratio,
                           freeu=freeu, sag_scale=float(sag_scale), conds=conds, ip=ip,
                           shard=shard)
        t0 = self._phase("denoise", t0)
        if return_latents:
            return shard.gather(lat).permute(0, 2, 3, 1).cpu().numpy()
        images = self.decode_uint8_device(lat, shard)
        if output_type == "device":
            self._phase("decode", t0)
            return images
        images = images.cpu().numpy()
        if ifr_state is not None:
            full, m_full, region = ifr_state
            images = np.stack([paste_region(full, im, region, m_full) for im in images])
        self._phase("decode", t0)
        return _to_output(images, output_type, single=n == 1)

    __call__ = generate

    def _lcm_guidance(self, added_cond: Optional[Dict], guidance_scale: float, n: int):
        """An LCM-distilled UNet (``time_cond_proj_dim``) takes the embedded
        guidance scale on all 2N rows, and the external CFG combine runs at
        1.0 (``pww_tpu/pipeline/pipeline.py:1858-1867``); other UNets: as
        given."""
        dim = self.config.unet.time_cond_proj_dim
        if dim is None:
            return added_cond, guidance_scale
        w_emb = guidance_scale_embedding(float(guidance_scale), dim, self.device)
        added_cond = dict(added_cond or {})
        added_cond["timestep_cond"] = w_emb[None].expand(2 * n, -1)
        return added_cond, 1.0

    def _edit_conds(self, edit_sched, schedule, t_start: int, n: int,
                    added_cond: Optional[Dict], encode_kw: Dict) -> Dict:
        """Prompt editing: {visit: (text_states, pww, added_cond)} for the
        visits from ``t_start``, each distinct (prompt, negative) rendering
        encoded once and tiled as the base prompt is; the schedule's ends
        are sampler steps, mapped to visits (pndm and heun visit some steps
        twice) (``pww_tpu/pipeline/pipeline.py:1962-2000, 2048-2098``)."""
        memo: Dict = {}
        bounds = []
        for end, pos, neg in edit_sched:
            vend = schedule.visit_of_step(end)
            if vend <= t_start:  # rows wholly before t_start never run
                continue
            if (pos, neg) not in memo:
                enc = self.encode_inputs(pos, encode_kw["color_map"],
                                         encode_kw["color_context"], neg,
                                         encode_kw["weight_function"],
                                         prompt_weighting=encode_kw["prompt_weighting"],
                                         clip_skip=encode_kw["clip_skip"],
                                         long_prompts=encode_kw["long_prompts"])
                ts, pww, pooled = self._tile_cfg(enc, n)
                ac = added_cond
                if added_cond is not None and pooled is not None:
                    ac = dict(added_cond, text_embeds=pooled.float())
                memo[pos, neg] = (ts, pww, ac)
            bounds.append((vend, memo[pos, neg]))
        conds, seg = {}, 0
        for i in range(t_start, schedule.num_steps):
            while bounds[seg][0] <= i:
                seg += 1
            conds[i] = bounds[seg][1]
        return conds

    def generate_hires(self, prompt: str = "", color_map_image=None,
                       color_context: Optional[Dict] = None, hires_scale: float = 2.0,
                       hires_strength: float = 0.7, hires_steps: Optional[int] = None,
                       upscale_mode: str = "latent", output_type: str = "pil", **kwargs):
        """The two-pass hires fix (A1111; ``pww_tpu/pipeline/pipeline.py:
        2145-2235``): generate at the color map's size, upscale by
        ``hires_scale`` to the UNet's lattice (the VAE factor times
        2^(blocks − 1)), then refine by img2img at ``hires_strength`` with
        ``hires_steps`` (default: the first pass's steps), on the color map
        NEAREST-resized so that the regions keep their places.
        ``upscale_mode="latent"`` resizes the scaled latents bilinearly
        (``jax.image.resize``'s "linear"); ``"image"`` decodes, resizes the
        pixels with PIL's Lanczos and encodes again (``num_samples`` 1).
        ``**kwargs``: :meth:`generate`'s, for both passes."""
        from PIL import Image

        cfg = self.config
        cm = _to_numpy_image(color_map_image)
        if cm is None:
            raise ValueError("generate_hires requires color_map_image")
        if upscale_mode not in ("latent", "image"):
            raise ValueError('upscale_mode must be "latent" or "image"')
        for key, alt in (("strength", "hires_strength"), ("init_image", None),
                         ("init_latents", None), ("return_latents", None)):
            if key in kwargs:
                hint = f" — use {alt} instead" if alt else ""
                raise ValueError(f"generate_hires manages {key!r} itself (the second pass "
                                 f"is an img2img refinement){hint}")
        h0, w0 = cm.shape[:2]
        mult = cfg.vae.scale_factor * 2 ** (len(cfg.unet.block_out_channels) - 1)
        h2 = max(mult, int(round(h0 * hires_scale / mult)) * mult)
        w2 = max(mult, int(round(w0 * hires_scale / mult)) * mult)
        cm2 = np.asarray(Image.fromarray(cm).resize((w2, h2), Image.NEAREST))
        steps = kwargs.pop("num_inference_steps", 30)
        steps2 = hires_steps or steps
        first = dict(prompt=prompt, color_map_image=cm, color_context=color_context,
                     num_inference_steps=steps, **kwargs)
        second = dict(prompt=prompt, color_map_image=cm2, color_context=color_context,
                      strength=hires_strength, num_inference_steps=steps2,
                      output_type=output_type, **kwargs)
        if upscale_mode == "latent":
            base = torch.from_numpy(self.generate(return_latents=True, **first))
            sf = cfg.vae.scale_factor
            up = resize_linear_antialias(base.permute(0, 3, 1, 2), h2 // sf, w2 // sf)
            return self.generate(init_latents=up.permute(0, 2, 3, 1).numpy(), **second)
        if kwargs.get("num_samples", 1) != 1:
            raise ValueError('upscale_mode="image" supports num_samples=1; use "latent"')
        base = self.generate(output_type="np", **first)
        up_img = Image.fromarray(base[0]).resize((w2, h2), Image.LANCZOS)
        return self.generate(init_image=up_img, **second)

    # -- serving -------------------------------------------------------------------
    def _prewarm_text_cache(self, requests: Sequence[Dict]) -> None:
        """One text-encoder call for a ``generate_batch`` group: the group's
        uncached (prompt, negative) pairs as one (2K, 77) batch, K padded to
        the next power of two with ("", "") pairs whose outputs are
        dropped, seeding the text cache so that the per-request encodes hit
        it (``pww_tpu/pipeline/pipeline.py:2237``). SDXL-base's two towers
        take the same rows (the second tokenizer's ids for the second
        tower) in one call of each, and each pair is cached as its own
        encode would cache it: states and pooled vector, both zeroed in the
        uncond row for an empty negative prompt where the configuration
        forces zeros. The JAX package's method leaves two-tower groups to
        the per-request encodes; the cached values are the same, only the
        number of tower calls differs. Weighted, long and clip-skip
        requests, and the refiner's one projected tower, take their own
        encode. Fewer than two pairs: nothing to share."""
        if self.config.xl_refiner:
            return
        pairs = [(str(r.get("prompt", "")), str(r.get("negative_prompt", "")))
                 for r in requests
                 if not (r.get("prompt_weighting") or r.get("long_prompts")
                         or int(r.get("clip_skip", 0)))]
        with self._encode_lock:
            todo = [p for p in dict.fromkeys(pairs)
                    if (p[0], p[1], False, 0, False) not in self._text_cache]
            if len(todo) < 2:
                return
            k = 1 << (len(todo) - 1).bit_length()
            rows, rows2 = [], []
            for p, neg in todo + [("", "")] * (k - len(todo)):
                rows += [padded_ids(self.tokenizer, neg), padded_ids(self.tokenizer, p)]
                if self.tokenizer_2 is not None:
                    rows2 += [padded_ids(self.tokenizer_2, neg),
                              padded_ids(self.tokenizer_2, p)]
            ids, ids2 = (torch.tensor(r, dtype=torch.int64, device=self.device) if r else None
                         for r in (rows, rows2))
            out = self.encode_text(ids, ids2)
            states, pooled = out if isinstance(out, tuple) else (out, None)
            zero = self.config.force_zeros_for_empty_prompt and pooled is not None
            for i, (p, neg) in enumerate(todo):
                s = states[2 * i:2 * i + 2]
                pl = None if pooled is None else pooled[2 * i:2 * i + 2]
                if zero and neg == "":
                    s, pl = s.clone(), pl.clone()
                    s[0] = 0.0
                    pl[0] = 0.0
                cache_text(self._text_cache, (p, neg, False, 0, False), (s, pl))

    @torch.inference_mode()
    def generate_batch(
        self,
        requests: Sequence[Dict],
        num_inference_steps: int = 30,
        guidance_scale: float = 7.5,
        weight_function: Optional[AnyWeightFunction] = None,
        noise_mode: str = "jax",
        output_type: str = "pil",
        strength: float = 0.5,  # img2img noise level, shared: it sets t_start
        cache_interval: int = 1,
        tome_ratio: float = 0.0,
        freeu=None,  # FreeU: True (the family's defaults) or (b1, b2, s1, s2)
        sag_scale: float = 0.0,
        ip_adapter_image=None,  # one reference image shared by the batch
        **unported,
    ):
        """N independent paint-with-words requests as one batched denoise
        (``pww_tpu/pipeline/pipeline.py:2297-2709``).

        Each request dict: ``prompt``, ``color_map_image``, ``color_context``,
        ``seed``, optional ``negative_prompt``, ``prompt_weighting``,
        ``clip_skip`` and ``long_prompts``; img2img and inpaint requests add
        ``init_image`` (and ``mask_image``, ``mask_blur``, ``masked_content``).
        The requests share resolution, text length, color-map grid, mode,
        steps, guidance, the weight function and ``strength``; anything else
        raises ``ValueError``. Rows are [uncond_0..uncond_{N-1},
        cond_0..cond_{N-1}] for the text states, the weight pyramids, the
        pooled vectors and ``time_ids``. Each request's latent noise,
        regional seeds, posterior sample, "latent_noise" fill and
        stochastic-scheduler step noise come from its own seed, as
        :meth:`generate` draws them, so that row i is request i served
        alone up to the batch's rounding. A custom weight function takes
        the split CFG path. SDXL rows get ``time_ids`` of their own size,
        with no crop, and the refiner's aesthetic scores 6.0 / 2.5. The
        extras ``cache_interval``, ``tome_ratio``, ``freeu`` and
        ``sag_scale`` apply to the whole batch, as in :meth:`generate`, and
        an LCM-distilled UNet takes the embedded guidance scale. With an
        IP-Adapter attached, ``ip_adapter_image`` conditions every row, at
        the adapter's scale.

        With ``profile=True`` the call records the phases "text" (the
        group's text encode, :meth:`_prewarm_text_cache`), "encode" (the
        per-request pyramids, time ids and noise), "denoise" and "decode".

        Returns PIL images, a (N, H, W, 3) uint8 array (``"np"``), or the
        un-fetched uint8 tensor on the pipeline's device (``"device"``).
        """
        refuse_unported("generate_batch", unported)
        freeu = freeu_params(freeu, self.config.is_xl)
        tome_ratio = float(tome_ratio)
        check_noise_mode(noise_mode)
        if output_type not in ("pil", "np", "device"):
            raise ValueError(f"output_type must be 'pil', 'np' or 'device', got "
                             f"{output_type!r}")
        cfg = self.config
        t0 = time.perf_counter()
        wf = as_weight_function(weight_function)
        self._prewarm_text_cache(requests)
        t0 = self._phase("text", t0)
        encs = [self.encode_inputs(
            r.get("prompt", ""), _to_numpy_image(r.get("color_map_image")),
            r.get("color_context") or {}, r.get("negative_prompt", ""), wf,
            prompt_weighting=bool(r.get("prompt_weighting", False)),
            clip_skip=int(r.get("clip_skip", 0)),
            long_prompts=bool(r.get("long_prompts", False))) for r in requests]

        # one mode for the whole batch: txt2img, img2img or inpaint
        has_init = [r.get("init_image") is not None for r in requests]
        has_mask = [r.get("mask_image") is not None for r in requests]
        if any(has_init) and not all(has_init):
            raise ValueError("all requests in a batch must agree on img2img (init_image)")
        if any(has_mask):
            if not all(has_mask):
                raise ValueError("all requests in a batch must agree on inpainting "
                                 "(mask_image)")
            if not all(has_init):
                raise ValueError("inpainting requires init_image alongside mask_image")
        img2img = len(requests) > 0 and all(has_init)
        inpaint = img2img and all(has_mask)
        legacy_inpaint = inpaint and cfg.unet.in_channels == cfg.vae.latent_channels
        for r in requests:
            mc = r.get("masked_content", "original")
            check_masked_content(mc, r.get("mask_blur"), inpaint)
            if mc in ("latent_noise", "latent_nothing") and inpaint and not legacy_inpaint:
                raise ValueError(f"masked_content={mc!r} applies to the legacy "
                                 "masked-blend path (standard 4-channel checkpoints)")

        # img2img runs at the init image's size floored to a multiple of 32,
        # as generate does; txt2img at the color map's
        dims = []
        for r, e in zip(requests, encs):
            if r.get("init_image") is not None:
                ih, iw = _image_hw(r["init_image"], default=(512, 512))
                dims.append((ih - ih % 32, iw - iw % 32))
            else:
                dims.append((e.height, e.width))
        h0, w0 = dims[0]
        if any(d != (h0, w0) for d in dims[1:]):
            raise ValueError("all requests in a batch must share resolution")
        if any(e.text_states.shape[1] != encs[0].text_states.shape[1] for e in encs[1:]):
            raise ValueError("all requests in a batch must share the text length "
                             "(long_prompts window counts differ)")
        if any(e.pww.weights.keys() != encs[0].pww.weights.keys() for e in encs[1:]):
            raise ValueError("all requests in a batch must share the color-map grid "
                             "(the PwW weight pyramids have different spatial keys)")

        n = len(requests)

        def rows(xs):  # [uncond_0..uncond_{n-1}, cond_0..cond_{n-1}]
            return torch.cat([x[:1] for x in xs] + [x[1:] for x in xs])

        text_states = rows([e.text_states for e in encs])
        pww = PwwState(
            weights={k: rows([e.pww.weights[k] for e in encs]) for k in encs[0].pww.weights},
            weight_orig=rows([e.pww.weight_orig for e in encs]),
            sigma=torch.zeros((), dtype=torch.float32, device=self.device), weight_fn=wf)
        added_cond = None
        if cfg.needs_pooled:
            # each request's own size: the color map's, else the raw init
            # image's (pww_tpu/pipeline/pipeline.py:2444-2470)
            sizes = [_image_hw(r["init_image"], default=(512, 512))
                     if r.get("init_image") is not None and r.get("color_map_image") is None
                     else (e.height, e.width) for r, e in zip(requests, encs)]
            added_cond = {"text_embeds": rows([e.pooled for e in encs]).float(),
                          "time_ids": micro_time_ids(cfg.xl_refiner, sizes, [(0, 0)] * n,
                                                     sizes, 6.0, 2.5, self.device)}

        schedule = self.scheduler.set_timesteps(num_inference_steps, self.device)
        sf = cfg.vae.scale_factor
        seeds = [int(r.get("seed", 0)) for r in requests]
        t_start, extra, blend = 0, None, None
        if img2img:
            t_start = self._t_start(num_inference_steps, strength, schedule)
            parts = []
            for r, seed in zip(requests, seeds):
                init = preprocess_image(r["init_image"])
                if init.shape[1:3] != (h0, w0):
                    raise ValueError(f"all requests in a batch must share resolution (init "
                                     f"image gives {init.shape[1]}x{init.shape[2]}, batch "
                                     f"is {h0}x{w0})")
                parts.append(self._image_latents(
                    init, r.get("mask_image"), float(r.get("mask_blur", 0.0)),
                    r.get("masked_content", "original"), seed, 1, schedule, t_start,
                    noise_mode, "sample", legacy_inpaint))
            lat = torch.cat([p[0] for p in parts])
            if inpaint and not legacy_inpaint:
                extra = torch.cat([p[1] for p in parts])
            elif legacy_inpaint:
                blend = tuple(torch.cat(xs) for xs in zip(*(p[2] for p in parts)))
        else:
            shape = (1, cfg.vae.latent_channels, h0 // sf, w0 // sf)
            lat = torch.cat([regional_seed_latents(make_noise(seed, shape, noise_mode,
                                                              self.device), e.regions,
                                                   noise_mode)
                             for seed, e in zip(seeds, encs)])
            lat = lat * schedule.init_noise_sigma
        added_cond, guidance_scale = self._lcm_guidance(added_cond, guidance_scale, n)
        ip = self._ip_for_call(ip_adapter_image, n)
        shard = BatchRows(self.mesh, n)
        t0 = self._phase("encode", t0)
        lat = self.denoise(lat, text_states, pww, schedule, float(guidance_scale),
                           t_start=t_start, extra=extra, blend=blend, seeds=seeds,
                           added_cond=added_cond, cache_interval=int(cache_interval),
                           tome_ratio=tome_ratio, freeu=freeu, sag_scale=float(sag_scale),
                           ip=ip, shard=shard)
        t0 = self._phase("denoise", t0)
        images = self.decode_uint8_device(lat, shard)
        if output_type != "device":
            images = _to_output(images.cpu().numpy(), output_type, single=False)
        self._phase("decode", t0)
        return images

    def _t_start(self, steps: int, strength: float, schedule) -> int:
        """The first visit of an img2img run at ``strength``."""
        return truncation_checked(
            t_start_from_strength(steps, strength, self.config.scheduler.steps_offset),
            schedule)

    def _image_latents(self, init: np.ndarray, mask_image, mask_blur: float,
                       masked_content: str, seed: int, n: int, schedule, t_start: int,
                       noise_mode: str, vae_sample_mode: str, legacy_inpaint: bool,
                       rng=None):
        """img2img and inpaint: the preprocessed init image's (1, H, W, 3)
        latents, ``n`` times, re-noised at visit ``t_start`` →
        (latents, 9-channel inpaint's extra channels or None, the legacy
        blend or None). ``generate`` and ``generate_batch`` (one request at a
        time) share it, so that a batched row starts where the request
        served alone starts. The posterior sample and the "latent_noise" fill
        draw from :func:`image_keys` (``seed``, ``rng``), the sample in the
        dtype of the JAX pipeline's moments, its compute dtype."""
        cfg = self.config
        sf = cfg.vae.scale_factor
        inpaint = mask_image is not None
        proc_mask = None
        if inpaint:
            proc_mask = self._prepare_pixel_mask(mask_image, init, mask_blur)
            if masked_content == "fill":
                init = fill_masked_region(init[0], proc_mask >= 0.5)[None]
        moments = self.encode_image(init)
        k_sample, k_noise = image_keys(seed, rng)
        if vae_sample_mode == "mean":
            init_lat = moments[:, :cfg.vae.latent_channels]
        elif vae_sample_mode == "sample":
            init_lat = sample_from_moments(
                moments, k_sample, "bfloat16" if self.dtype == torch.bfloat16 else "float32")
        else:
            raise ValueError(f"vae_sample_mode must be 'sample' or 'mean', got "
                             f"{vae_sample_mode!r}")
        init_lat = (init_lat * cfg.vae.scaling_factor).repeat(n, 1, 1, 1)
        extra = blend = None
        if legacy_inpaint:
            m_lat = resize_linear_antialias(torch.from_numpy(proc_mask).to(self.device),
                                            init.shape[1] // sf, init.shape[2] // sf)
            m_lat = torch.clamp(m_lat, 0.0, 1.0)[None, None].expand(n, 1, -1, -1)
            hole = (m_lat >= 0.5).float()
            if masked_content == "latent_noise":
                fresh = normal_nchw(k_noise, tuple(init_lat.shape), self.device)
                init_lat = init_lat * (1.0 - hole) + fresh * hole
            elif masked_content == "latent_nothing":
                init_lat = init_lat * (1.0 - hole)
        noise = make_noise(seed, tuple(init_lat.shape), noise_mode, self.device)
        # the 9-channel path noises at the strength's step even at strength
        # 1.0, as the reference's inpaint does (inpaint.py:180-198)
        lat = schedule.add_noise(init_lat, noise, t_start)
        if legacy_inpaint:
            blend = (m_lat, init_lat, noise)
        elif inpaint:
            extra = self._prepare_inpaint_channels(init, proc_mask, n)
            if cfg.unet.in_channels != cfg.vae.latent_channels + extra.shape[1]:
                raise ValueError(
                    f"UNet expects {cfg.unet.in_channels} input channels but "
                    f"latents+mask+masked_image = "
                    f"{cfg.vae.latent_channels + extra.shape[1]}; pass an "
                    "inpainting checkpoint (9-channel UNet)")
        return lat, extra, blend

    def _control_inputs(self, control_image, scale, proc_hw, n: int):
        """[(ControlNet, (n, 3, H, W) f32 hint on the device, scale)] for the
        attached nets; a single hint or scale is shared by every net
        (``pww_tpu/pipeline/pipeline.py:1736-1796``)."""
        nets = self.controlnets
        if not nets:
            raise ValueError("control_image given but no ControlNet loaded; call "
                             "pipeline.load_controlnet(...) first")
        k = len(nets)
        if k == 1:
            if isinstance(control_image, (list, tuple)) or isinstance(scale, (list, tuple)):
                raise ValueError("a list of control images or conditioning scales requires "
                                 "stacked ControlNets; call pipeline.add_controlnet(...)")
            images, scales = [control_image], [scale]
        else:
            images = (list(control_image) if isinstance(control_image, (list, tuple))
                      else [control_image] * k)
            if len(images) != k:
                raise ValueError(f"{k} ControlNets attached but {len(images)} control "
                                 "images given")
            scales = list(scale) if isinstance(scale, (list, tuple)) else [scale] * k
            if len(scales) != k:
                raise ValueError(f"{k} ControlNets attached but {len(scales)} conditioning "
                                 "scales given")
        out = []
        for net, img, sc in zip(nets, images, scales):
            hint = torch.from_numpy(_load_hint(img, 3, proc_hw, "control_image"))
            hint = hint.permute(2, 0, 1)[None].expand(n, -1, -1, -1)
            out.append((net, hint.to(self.device), float(sc)))
        return out

    # -- inpaint helpers -----------------------------------------------------------
    def _crop_for_full_res(self, init_image, mask_image, color_map, control_image,
                           adapter_image, mask_blur: float, padding: int):
        """A1111 "inpaint area: only masked": crop the blurred mask's padded,
        aspect-matched bounding box and scale the crop of the init image, the
        mask, the color map and the hints up to the full processing size.
        Returns them and (init, feathered mask, region) for
        :func:`paste_region`."""
        from PIL import Image

        init_np = _to_numpy_image(init_image)  # (H, W, 3) uint8
        fh, fw = init_np.shape[:2]
        mask_np = self._prepare_pixel_mask(mask_image, init_np[None], 0.0)
        # blur once at full resolution; the crop grows from the blurred
        # mask's support, so the feather lands inside it
        mask_full = blur_mask(mask_np, mask_blur)
        x0, y0, x1, y1 = expand_crop_region((mask_full > 1e-3).astype(np.float32),
                                            padding, fw, fh)

        def up(arr, resample):
            return np.asarray(Image.fromarray(arr).resize((fw, fh), resample))

        crop_init = up(init_np[y0:y1, x0:x1], Image.LANCZOS)
        crop_mask = np.clip(np.asarray(Image.fromarray(mask_full[y0:y1, x0:x1], mode="F")
                                       .resize((fw, fh), Image.BILINEAR)), 0.0, 1.0)
        if color_map is not None:
            if color_map.shape[:2] != (fh, fw):
                color_map = np.asarray(Image.fromarray(color_map).resize((fw, fh),
                                                                         Image.NEAREST))
            color_map = up(color_map[y0:y1, x0:x1], Image.NEAREST)

        def crop_hint(img):
            a = _to_numpy_image(img)
            if a.shape[:2] != (fh, fw):
                a = np.asarray(Image.fromarray(a).resize((fw, fh), Image.LANCZOS))
            return up(a[y0:y1, x0:x1], Image.LANCZOS)

        if isinstance(control_image, (list, tuple)):
            control_image = [crop_hint(c) for c in control_image]
        elif control_image is not None:
            control_image = crop_hint(control_image)
        if adapter_image is not None:
            adapter_image = crop_hint(adapter_image)
        return (crop_init, crop_mask, color_map, control_image, adapter_image,
                (init_np, mask_full, (x0, y0, x1, y1)))

    def _prepare_pixel_mask(self, mask_image, init, mask_blur: float) -> np.ndarray:
        """(H, W) f32 mask in [0, 1] at the preprocessed init's size,
        optionally gaussian-feathered; array masks must lie in [0, 1]."""
        from PIL import Image

        ih, iw = int(init.shape[1]), int(init.shape[2])
        m = mask_image
        if isinstance(m, Image.Image):
            m = m.convert("L")
            if m.size != (iw, ih):
                m = m.resize((iw, ih), Image.NEAREST)
            m = np.asarray(m, np.float32) / 255.0
        else:
            m = np.asarray(m, np.float32)
            if m.ndim == 3:
                m = m[..., 0]
            if m.min() < 0.0 or m.max() > 1.0:
                raise ValueError("mask should be in [0, 1] range")
            if m.shape != (ih, iw):
                pil = Image.fromarray((m * 255).astype(np.uint8))
                m = np.asarray(pil.resize((iw, ih), Image.NEAREST), np.float32) / 255.0
        return blur_mask(np.clip(m, 0.0, 1.0), float(mask_blur))

    def _prepare_inpaint_channels(self, init: np.ndarray, mask_image, n: int) -> torch.Tensor:
        """(n, 1 + latent, h, w) compute-dtype channels: the binarized mask on
        the latent grid and the posterior mean of the masked image, scaled
        (reference `paint_with_words_inpaint.py:20-134`)."""
        ih, iw = int(init.shape[1]), int(init.shape[2])
        if _image_hw(mask_image, default=(ih, iw)) != (ih, iw):
            from PIL import Image

            m = mask_image
            if not isinstance(m, Image.Image):
                m = np.asarray(m)
                if m.dtype != np.uint8:
                    m = (np.clip(m, 0, 1) * 255).astype(np.uint8)
                m = Image.fromarray(m)
            mask_image = m.convert("L").resize((iw, ih), Image.NEAREST)
        mask, masked = prepare_mask_and_masked_image(init, mask_image)
        sf = self.config.vae.scale_factor
        mask_lat = resize_nearest(torch.from_numpy(mask[..., 0]), ih // sf, iw // sf)
        moments = self.encode_image(masked)
        masked_lat = moments[:, :self.config.vae.latent_channels] * self.config.vae.scaling_factor
        extra = torch.cat([mask_lat[:, None].to(self.device), masked_lat], dim=1)
        return extra.repeat(n, 1, 1, 1).to(self.dtype)
