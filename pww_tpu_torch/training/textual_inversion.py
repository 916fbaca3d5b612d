"""Textual-inversion training (Gal et al. 2022): learn a new concept token.

Port of :mod:`pww_tpu.training.textual_inversion`. The reference only
consumes trained embeddings (its TI notebook injects a downloaded
``learned_embeds.bin``); here the loop trains one: VAE latents noised at a
random timestep, CLIP on a random template with the placeholder, the UNet's
ε (or v) prediction, the f32 MSE, and Adam on the placeholder's new rows of
the CLIP token table, which are the only tensors that require a gradient.
The UNet, the VAE and the rest of CLIP stay frozen, as in the upstream
recipe, and the table's other rows stay bit for bit as they were.

The trainer comes in three parts: :class:`TextualInversionTrainer` sets up
(tokens, grown table, latents, templates), its :meth:`~TextualInversionTrainer.step`
takes ``(rows, optimizer, draws)`` and returns ``(loss, rows, optimizer)``,
and :func:`fit` draws ``(img_idx, tpl_idx, t, eps)`` each step from the
JAX package's own stream (``rng, k = split(rng)`` from ``PRNGKey(seed)``,
``k`` split four ways, ``pww_tpu/training/textual_inversion.py:172-179,
202-205``), the same numbers, on the host
(:mod:`pww_tpu_torch.utils.jax_random`).

Typical use::

    pipe = PwwPipeline.from_pretrained(...)
    result = train_textual_inversion(pipe, images, "<my-cat>",
                                     initializer_token="cat", num_steps=3000)
    result.save("learned_embeds.bin")        # diffusers format
    pipe.generate(prompt="a photo of <my-cat>", ...)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..pipeline.pipeline import preprocess_image
from ..conditioning.seeding import normal_nchw
from ..schedulers.schedules import make_betas
from ..utils import jax_random
from ..weights.textual_inversion import TOKEN_EMBEDDING, set_token_table

# The standard CLIP-style prompt templates from the textual-inversion paper
# (trimmed set; enough prompt diversity for the embedding to generalize).
DEFAULT_TEMPLATES = (
    "a photo of a {}",
    "a rendering of a {}",
    "the photo of a {}",
    "a photo of my {}",
    "a photo of the {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a good photo of the {}",
    "a photo of one {}",
)


@dataclasses.dataclass
class TIResult:
    """The trained embedding (f32, on the CPU) and the loss of every step."""

    placeholder: str
    embedding: torch.Tensor  # (n_vectors, hidden)
    losses: List[float]

    def save(self, path: str) -> None:
        """Write the diffusers ``{token: vec}`` file that
        :func:`~pww_tpu_torch.weights.textual_inversion.apply_textual_inversion`
        reads."""
        vec = self.embedding[0] if self.embedding.shape[0] == 1 else self.embedding
        torch.save({self.placeholder: vec.detach().cpu().clone()}, path)


def refuse_tp_cut(pipeline, what: str) -> None:
    """Training through a UNet cut over a mesh's tp axis is not ported: its
    collectives carry no gradient (ROADMAP A.20b). A dp-only mesh leaves
    the UNet whole, and every rank trains on the whole batch."""
    if getattr(pipeline.unet, "tp_cuts", None):
        raise NotImplementedError(
            f"{what} on a pipeline whose UNet is cut over tp is not ported to "
            f"pww_tpu_torch yet (ROADMAP A.20b): the tp collectives carry no gradient; "
            f"train on a pipeline without a mesh, or with tp 1")


def encode_latents(pipeline, images: Sequence) -> torch.Tensor:
    """Images → scaled VAE latents (the posterior mean), (M, 4, h, w) f32,
    made outside autograd and outside inference mode."""
    scale = pipeline.config.vae.scaling_factor
    with torch.no_grad():
        lats = [pipeline.encode_image(preprocess_image(im)).chunk(2, dim=1)[0] * scale
                for im in images]
    return torch.cat(lats).float()


def alphas_cumprod(pipeline) -> torch.Tensor:
    """ᾱ_t of the training schedule, f32 on the pipeline's device."""
    a = np.cumprod(1.0 - make_betas(pipeline.config.scheduler)).astype(np.float32)
    return torch.from_numpy(a).to(pipeline.device)


def denoising_loss(pipeline, unet: Callable, latents: torch.Tensor, a_cum: torch.Tensor,
                   img_idx: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
                   text: torch.Tensor) -> torch.Tensor:
    """The f32 MSE of ``unet(noised, t, text)`` against ε (or v for a
    v-prediction UNet), the latents ``latents[img_idx]`` noised with ``eps``
    at ``t``."""
    x0 = latents[img_idx]
    a_t = a_cum[t][:, None, None, None]
    noised = a_t.sqrt() * x0 + (1.0 - a_t).sqrt() * eps
    if pipeline.config.unet.prediction_type == "v_prediction":
        target = a_t.sqrt() * eps - (1.0 - a_t).sqrt() * x0
    else:
        target = eps
    dtype = pipeline.dtype
    pred = unet(noised.to(dtype), t.float(), text.to(dtype))
    return torch.mean((pred.float() - target) ** 2)


def randint(key, batch_size: int, high: int) -> torch.Tensor:
    """``jax.random.randint(key, (batch_size,), 0, high)`` as an int64 tensor."""
    return torch.from_numpy(jax_random.randint(key, (batch_size,), 0, high)).long()


def adam(params: Sequence[torch.Tensor], learning_rate: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no weight decay)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def fit(trainer, trainables, optimizer, num_steps: int, batch_size: int, seed: int,
        log_every: Optional[int], tag: str) -> Tuple[object, List[float]]:
    """``num_steps`` of ``trainer.step``, each on ``trainer.draws(k)`` where
    ``key, k = split(key)`` from ``PRNGKey(seed)``, as the JAX loops step;
    returns (the trained tensors, the loss of every step)."""
    key = jax_random.PRNGKey(seed)
    losses: List[float] = []
    for step in range(num_steps):
        key, k = jax_random.split(key)
        draws = trainer.draws(k, batch_size)
        loss, trainables, optimizer = trainer.step(trainables, optimizer, draws)
        losses.append(float(loss))
        if log_every and (step + 1) % log_every == 0:
            print(f"{tag} step {step + 1}/{num_steps}: loss {losses[-1]:.5f}")
    return trainables, losses


class TextualInversionTrainer:
    """The set-up of :func:`train_textual_inversion`: registers the
    placeholder's names with the tokenizer, keeps the CLIP table's rows
    and the new rows' initial value, encodes the images and tokenizes the
    templates. The pipeline's table changes only at :meth:`install`."""

    def __init__(self, pipeline, images: Sequence, placeholder: str,
                 initializer_token: str = "thing", num_vectors: int = 1,
                 templates: Sequence[str] = DEFAULT_TEMPLATES):
        if pipeline.config.is_xl:
            # before mutating anything: the tokenizer is shared state, and the
            # step would feed one tower's states to a UNet expecting two
            raise NotImplementedError(
                "train_textual_inversion targets single-encoder SD models (the XL "
                "dual-encoder and micro-conditioning path is inference-only here); "
                "train on SD-1.x/2.x or inject an XL embedding with "
                "apply_textual_inversion")
        refuse_tp_cut(pipeline, "train_textual_inversion")
        self.pipeline = pipeline
        tokenizer = pipeline.tokenizer
        self.table = pipeline.clip.text_model.embeddings.token_embedding.weight.detach()
        n_old = self.table.shape[0]
        init_ids = [i for i in tokenizer(initializer_token)["input_ids"]
                    if i not in (tokenizer.bos_token_id, tokenizer.eos_token_id)]
        init_row = (self.table[init_ids[0]] if init_ids else self.table.float().mean(dim=0)).float()
        names = [placeholder] + [f"{placeholder}_{i}" for i in range(1, num_vectors)]
        for name in names:
            tokenizer.add_tokens(name)
        ids = [int(tokenizer.convert_tokens_to_ids(name)) for name in names]
        if ids != list(range(n_old, n_old + num_vectors)):
            raise ValueError(
                f"the new rows of the CLIP table are {n_old}..{n_old + num_vectors - 1}, but "
                f"the tokenizer gives {names} the ids {ids}: a name already registered, or "
                f"a tokenizer and table of different sizes")
        self.init_rows = init_row[None].repeat(num_vectors, 1)
        self.phrase = " ".join(names)
        self.latents = encode_latents(pipeline, images)
        max_len = tokenizer.model_max_length
        self.ids = torch.tensor(
            [tokenizer(t.format(self.phrase), max_length=max_len, truncation=True,
                       padding="max_length")["input_ids"] for t in templates],
            dtype=torch.long, device=pipeline.device)
        self.alphas_cumprod = alphas_cumprod(pipeline)

    def init(self, learning_rate: float) -> Tuple[torch.Tensor, torch.optim.Adam]:
        """The new rows, an f32 leaf that requires a gradient, and their Adam."""
        rows = self.init_rows.clone().requires_grad_(True)
        return rows, adam([rows], learning_rate)

    def draws(self, key, batch_size: int):
        """(img_idx, tpl_idx, t, eps) for one step from the step's key, split
        four ways as the JAX step splits it (ε drawn NHWC, given NCHW)."""
        m, c, h, w = self.latents.shape
        k_img, k_tpl, k_t, k_eps = jax_random.split(key, 4)
        return (randint(k_img, batch_size, m), randint(k_tpl, batch_size, self.ids.shape[0]),
                randint(k_t, batch_size, self.pipeline.config.scheduler.num_train_timesteps),
                normal_nchw(k_eps, (batch_size, c, h, w)))

    def step(self, rows: torch.Tensor, optimizer: torch.optim.Adam, draws):
        """One Adam step of the new rows on ``draws``; returns (loss, rows,
        optimizer)."""
        img_idx, tpl_idx, t, eps = (x.to(self.pipeline.device) for x in draws)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            table = torch.cat([self.table, rows.to(self.table.dtype)])
            text = functional_call(self.pipeline.clip, {TOKEN_EMBEDDING: table},
                                   (self.ids[tpl_idx],))
            loss = denoising_loss(self.pipeline, self.pipeline.unet, self.latents,
                                  self.alphas_cumprod, img_idx, t, eps, text)
            loss.backward()
        optimizer.step()
        return loss.detach(), rows, optimizer

    def install(self, rows: torch.Tensor) -> None:
        """Write the grown table into the pipeline's CLIP and config, and
        drop its encode caches."""
        set_token_table(self.pipeline,
                        torch.cat([self.table, rows.detach().to(self.table.dtype)]))


def train_textual_inversion(
    pipeline,
    images: Sequence,
    placeholder: str,
    initializer_token: str = "thing",
    num_vectors: int = 1,
    num_steps: int = 500,
    batch_size: int = 1,
    learning_rate: float = 5e-3,
    seed: int = 0,
    templates: Sequence[str] = DEFAULT_TEMPLATES,
    log_every: Optional[int] = None,
) -> TIResult:
    """Learn ``placeholder`` from ``images`` on a frozen SD pipeline.

    Mutates ``pipeline`` in place (tokenizer and grown CLIP table, as
    :func:`~pww_tpu_torch.weights.textual_inversion.apply_textual_inversion`
    does), so the concept is usable at once in prompts and color-context
    labels. Returns a :class:`TIResult` whose ``.save()`` writes the
    diffusers file.
    """
    trainer = TextualInversionTrainer(pipeline, images, placeholder, initializer_token,
                                      num_vectors, templates)
    rows, optimizer = trainer.init(learning_rate)
    rows, losses = fit(trainer, rows, optimizer, num_steps, batch_size, seed, log_every, "TI")
    trainer.install(rows)
    return TIResult(placeholder=trainer.phrase, embedding=rows.detach().float().cpu(),
                    losses=losses)
