"""LoRA training (Hu et al. 2021): learn low-rank adapters on a frozen SD.

Port of :mod:`pww_tpu.training.lora`. The low-rank factors are the only
tensors that require a gradient: each step merges ``W + (alpha/r)·A@B``
into the frozen UNet's attention weights functionally
(``torch.func.functional_call``; the pipeline's UNet is not mutated), then
the ε-prediction MSE and Adam, as in
:mod:`~pww_tpu_torch.training.textual_inversion`. The merge is the one
:meth:`~pww_tpu_torch.pipeline.pipeline.PwwPipeline.load_lora` applies at
inference, so train → save → load gives back the trained weights.

As the TI trainer, it comes in three parts (:class:`LoraTrainer`, its
:meth:`~LoraTrainer.step`, and the loop), and draws what the JAX package
draws (``pww_tpu/training/lora.py:134-140, 177-183, 204-207``), on the
host: each site's initial A from ``fold_in(PRNGKey(seed), i)`` (sites in
the JAX parameter tree's order, which is the sorted order of the port's
keys), and the steps' ``(img_idx, t, eps)`` from ``PRNGKey(seed + 1)``.

On a pipeline whose UNet is cut over a mesh's tp axis the factors are cut
like their weights (``pww_tpu/parallel/mesh.py:71-80``'s rules,
:func:`~pww_tpu_torch.parallel.mesh.cut_index`): at a weight cut by output
rows (``to_q``/``to_k``/``to_v``) each rank holds B's columns and all of A,
at one cut by input columns (``to_out``) A's rows and all of B. The whole
factor is drawn and then cut. A factor every rank holds whole gets its
gradient summed over tp before Adam steps, so that the copies stay equal;
the result holds the whole factors, gathered.

Typical use::

    pipe = PwwPipeline.from_pretrained(...)
    result = train_lora(pipe, images, captions, rank=8, num_steps=1000)
    result.save("my_style_lora.safetensors")   # kohya format
    pipe.load_lora(result.state_dict())        # or the saved file
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

import torch.distributed as dist

from ..conditioning.seeding import normal_nchw
from ..parallel.mesh import cut_index, gather_cut, tp_of
from ..utils import jax_random
from ..weights.safetensors_io import save_file
from .textual_inversion import (adam, alphas_cumprod, denoising_loss, encode_latents, fit,
                                randint)

# attention linears: kohya's default UNet target set
DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")

Factors = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class LoraTrainResult:
    """Trained factors and the loss of every step.

    ``factors`` maps a UNet weight's name (diffusers', e.g.
    ``…attn1.to_out.0.weight``) to ``a`` (in, r) and ``b`` (r, out), f32 on
    the CPU, the JAX package's layout; the kohya export transposes them to
    ``lora_down`` (r, in) and ``lora_up`` (out, r).
    """

    factors: Factors
    alpha: float
    rank: int
    losses: List[float]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The kohya-format flat state dict (``load_lora`` reads it)."""
        sd = {}
        for key, f in self.factors.items():
            name = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
            sd[name + ".lora_down.weight"] = f["a"].float().T.contiguous()
            sd[name + ".lora_up.weight"] = f["b"].float().T.contiguous()
            sd[name + ".alpha"] = torch.tensor(self.alpha, dtype=torch.float32)
        return sd

    def save(self, path: str) -> None:
        save_file(self.state_dict(), path)


def target_sites(unet: torch.nn.Module, targets: Sequence[str]) -> List[str]:
    """The names of the 2-D weights of the modules in ``targets`` under an
    attention module (``attn1``, ``attn2``); ``to_out`` is diffusers'
    ``to_out.0``."""
    sites = []
    for key, p in unet.named_parameters():
        parts = key.split(".")
        if parts[-1] != "weight" or p.dim() != 2:
            continue
        module = parts[-3] if parts[-3:-1] == ["to_out", "0"] else parts[-2]
        if module in targets and any("attn" in part for part in parts[:-2]):
            sites.append(key)
    return sites


class LoraTrainer:
    """The set-up of :func:`train_lora`: the target sites, the captions'
    text states (one encode each) and the images' latents."""

    def __init__(self, pipeline, images: Sequence, captions, rank: int = 8,
                 alpha: Optional[float] = None, targets: Sequence[str] = DEFAULT_TARGETS):
        if isinstance(captions, str):
            captions = [captions] * len(images)
        if len(captions) != len(images):
            raise ValueError("need one caption per image (or a single str)")
        if pipeline.config.is_xl:
            raise NotImplementedError(
                "train_lora targets single-encoder SD models (the XL micro-conditioning "
                "path is inference-only here); train on SD-1.x/2.x or use an XL LoRA "
                "through load_lora")
        self.pipeline = pipeline
        self.rank = rank
        self.alpha = float(rank if alpha is None else alpha)
        self.scale = self.alpha / rank
        params = dict(pipeline.unet.named_parameters())
        self.base = {key: params[key] for key in target_sites(pipeline.unet, targets)}
        if not self.base:
            raise ValueError(f"no UNet attention weights match targets={targets}")
        # {site: (cut dimension of W, its whole size)} where tp cuts the UNet
        cuts = getattr(pipeline.unet, "tp_cuts", {})
        self.cuts = {key: cuts[key] for key in self.base if key in cuts}
        tokenizer = pipeline.tokenizer
        max_len = tokenizer.model_max_length
        ids = torch.tensor(
            [tokenizer(c, max_length=max_len, truncation=True,
                       padding="max_length")["input_ids"] for c in captions],
            dtype=torch.long, device=pipeline.device)
        with torch.no_grad():
            enc = pipeline.encode_text(ids)
        self.text_states = (enc[0] if isinstance(enc, tuple) else enc).float()
        self.latents = encode_latents(pipeline, images)
        self.alphas_cumprod = alphas_cumprod(pipeline)

    def init(self, seed: int, learning_rate: float) -> Tuple[Factors, torch.optim.Adam]:
        """A ~ N(0, 1)/r (in, r) and B = 0 (r, out) for every site, the i-th
        site's A from ``fold_in(PRNGKey(seed), i)``, sites in sorted order;
        f32 leaves that require a gradient, and their Adam."""
        k0 = jax_random.PRNGKey(seed)
        factors = {}
        for i, key in enumerate(sorted(self.base)):
            shape = list(self.base[key].shape)  # (out, in), this rank's cut
            dim, full = self.cuts.get(key, (None, None))
            if dim is not None:
                shape[dim] = full
            out_dim, in_dim = shape
            a = torch.from_numpy(jax_random.normal(jax_random.fold_in(k0, i),
                                                   (in_dim, self.rank))) / self.rank
            b = torch.zeros((self.rank, out_dim))
            if dim is not None:  # B's columns where W's rows are cut, A's rows where its columns
                rank, size, _ = tp_of(self.pipeline.mesh)
                idx = cut_index(key, full, rank, size)
                a, b = (a, b[:, idx]) if dim == 0 else (a[idx], b)
            factors[key] = {"a": a.to(self.pipeline.device).requires_grad_(True),
                            "b": b.to(self.pipeline.device).requires_grad_(True)}
        return factors, self.optimizer(factors, learning_rate)

    @staticmethod
    def optimizer(factors: Factors, learning_rate: float) -> torch.optim.Adam:
        return adam([t for f in factors.values() for t in (f["a"], f["b"])], learning_rate)

    def merged(self, factors: Factors) -> Dict[str, torch.Tensor]:
        """``(W.f32 + (alpha/r)·(A@B)ᵀ).to(W.dtype)`` at every site."""
        return {key: (w.float() + self.scale * (factors[key]["a"] @ factors[key]["b"]).T)
                .to(w.dtype) for key, w in self.base.items()}

    def draws(self, key, batch_size: int):
        """(img_idx, t, eps) for one step from the step's key, split three
        ways as the JAX step splits it (ε drawn NHWC, given NCHW)."""
        m, c, h, w = self.latents.shape
        k_img, k_t, k_eps = jax_random.split(key, 3)
        return (randint(k_img, batch_size, m),
                randint(k_t, batch_size, self.pipeline.config.scheduler.num_train_timesteps),
                normal_nchw(k_eps, (batch_size, c, h, w)))

    def step(self, factors: Factors, optimizer: torch.optim.Adam, draws):
        """One Adam step of the factors on ``draws``; returns (loss, factors,
        optimizer)."""
        img_idx, t, eps = (x.to(self.pipeline.device) for x in draws)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            merged = self.merged(factors)
            loss = denoising_loss(
                self.pipeline, lambda *args: functional_call(self.pipeline.unet, merged, args),
                self.latents, self.alphas_cumprod, img_idx, t, eps,
                self.text_states[img_idx])
            loss.backward()
        if self.cuts:  # the factors held whole at cut sites: each rank has its share
            group = tp_of(self.pipeline.mesh)[2]
            for key, (dim, _) in sorted(self.cuts.items()):
                dist.all_reduce(factors[key]["a" if dim == 0 else "b"].grad, group=group)
        optimizer.step()
        return loss.detach(), factors, optimizer

    def whole(self, factors: Factors) -> Factors:
        """The factors, those cut over tp gathered whole (the same on every
        rank)."""
        out = {}
        for key, f in factors.items():
            f = {k: v.detach() for k, v in f.items()}
            if key in self.cuts:
                dim, full = self.cuts[key]
                name, t_dim = ("b", 1) if dim == 0 else ("a", 0)
                f[name] = gather_cut(f[name], key, t_dim, full, self.pipeline.mesh)
            out[key] = f
        return out

    def result(self, factors: Factors, losses: List[float]) -> LoraTrainResult:
        return LoraTrainResult(
            factors={key: {k: v.float().cpu() for k, v in f.items()}
                     for key, f in self.whole(factors).items()},
            alpha=self.alpha, rank=self.rank, losses=losses)


def train_lora(
    pipeline,
    images: Sequence,
    captions,  # str or Sequence[str] (one per image)
    rank: int = 8,
    alpha: Optional[float] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
    num_steps: int = 500,
    batch_size: int = 1,
    learning_rate: float = 1e-4,
    seed: int = 0,
    log_every: Optional[int] = None,
) -> LoraTrainResult:
    """Train UNet attention LoRA factors on a frozen pipeline.

    ``pipeline`` is not mutated: apply the result with
    ``pipeline.load_lora(result.state_dict())`` (or save and load the file).
    """
    trainer = LoraTrainer(pipeline, images, captions, rank, alpha, targets)
    factors, optimizer = trainer.init(seed, learning_rate)
    factors, losses = fit(trainer, factors, optimizer, num_steps, batch_size, seed + 1,
                          log_every, "LoRA")
    return trainer.result(factors, losses)
