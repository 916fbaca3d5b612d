"""The reference's paint-with-words text-to-image, float32.

Worked out from the inputs alone (prompts, color maps, contexts, seeds and
the weights the benchmark drew), following the paint-with-words paper's
code and diffusers' LMS sampler:

* tokens: the benchmark's tokenizer, 77 positions; the negative prompt "";
* regions: an exact color match scaled by the strength; the label's tokens
  matched at every occurrence in the prompt's 77 ids (overlaps add); the
  masks resized bilinearly (corners aligned) to the latent grid divided by
  1, 2, 4 and 8, sizes by the paper's ``always_round``, and contracted with
  the token matches; the uncond row's weights are zero;
* text: SD-1.x the final LayerNorm of CLIP; SDXL the two towers' states
  entering their last layers, concatenated, and the second tower's pooled
  vector, all zero for the empty negative prompt, with time ids (h, w, 0,
  0, h, w);
* noise: ``jax.random.normal(PRNGKey(seed))`` in NHWC, times the largest
  sigma;
* LMS of order 4 on 1000 scaled-linear betas (0.00085 to 0.012), its
  coefficients integrated with ``scipy.integrate.quad``, every table
  rounded to float32; classifier-free guidance on the ε pair;
* decode: VAE of latents / scaling factor, clamp((x + 1) / 2), ×255 rounded.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..wordtok import padded_ids
from . import jaxnoise

LMS_ORDER = 4


def always_round(x: float) -> int:
    intx = int(x)
    if intx % 2 == 0:
        return intx if x < intx + 0.5 else intx + 1
    return round(x)


def lms_schedule(sc: Dict, steps: int) -> Dict[str, np.ndarray]:
    from scipy import integrate

    betas = np.linspace(sc["beta_start"] ** 0.5, sc["beta_end"] ** 0.5,
                        sc["num_train_timesteps"], dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    sig_full = np.sqrt((1.0 - ac) / ac)
    ts = np.linspace(0, sc["num_train_timesteps"] - 1, steps, dtype=np.float64)[::-1].copy()
    sig = np.concatenate([np.interp(ts, np.arange(sc["num_train_timesteps"]), sig_full), [0.0]])
    coeffs = np.zeros((steps, LMS_ORDER))
    for t in range(steps):
        order = min(t + 1, LMS_ORDER)
        for j in range(order):
            def poly(tau, j=j, order=order, t=t):
                prod = 1.0
                for k in range(order):
                    if k != j:
                        prod *= (tau - sig[t - k]) / (sig[t - j] - sig[t - k])
                return prod
            coeffs[t, j] = integrate.quad(poly, sig[t], sig[t + 1], epsrel=1e-4)[0]
    f = np.float32
    return {"timesteps": ts.astype(f), "sigmas": sig.astype(f), "coeffs": coeffs.astype(f),
            "init_sigma": f(sig.max())}


def regions(tok, request: Dict, prompt_ids: List[int]):
    """(R, H, W) strength-scaled masks and (R, 77) token matches."""
    cmap = np.asarray(request["color_map_image"])
    masks, match = [], []
    for color, ctx in request["color_context"].items():
        label, strength = ctx.rsplit(",", 1)
        masks.append((cmap == np.asarray(color, np.uint8)).all(-1).astype(np.float32)
                     * np.float32(float(strength)))
        sub = tok(label, truncation=True)["input_ids"][1:-1]
        row = np.zeros(len(prompt_ids), np.float32)
        for i in range(len(prompt_ids) - len(sub) + 1):
            if prompt_ids[i:i + len(sub)] == sub:
                row[i:i + len(sub)] += 1.0
        match.append(row)
    return np.stack(masks), np.stack(match)


def pww_weights(masks: np.ndarray, match: np.ndarray, device) -> Dict[int, torch.Tensor]:
    """{h·w: (h·w, 77)} at ratios 8, 16, 32, 64 of the color map."""
    m = torch.from_numpy(masks).to(device)
    t = torch.from_numpy(match).to(device)
    out = {}
    H, W = masks.shape[1:]
    for ratio in (8, 16, 32, 64):
        h, w = always_round(H / ratio), always_round(W / ratio)
        down = F.interpolate(m[None], size=(h, w), mode="bilinear", align_corners=True)[0]
        out[h * w] = torch.einsum("rq,rt->qt", down.reshape(len(m), h * w), t)
    return out


class Reference:
    """The reference for one configuration and one set of weights (f32,
    on ``device``); ``tok`` and ``tok2`` the benchmark's tokenizers."""

    def __init__(self, config: Dict, models: Dict[str, torch.nn.Module], tok, tok2=None):
        self.cfg, self.m, self.tok, self.tok2 = config, models, tok, tok2
        self.xl = "clip2" in models
        self.device = next(models["unet"].parameters()).device

    def encode(self, prompt: str):
        """(text states (2, 77, D), pooled (2, P) or None), rows [uncond, cond]."""
        ids = torch.tensor([padded_ids(self.tok, ""), padded_ids(self.tok, prompt)],
                           device=self.device)
        if not self.xl:
            return self.m["clip"](ids), None
        ids2 = torch.tensor([padded_ids(self.tok2, ""), padded_ids(self.tok2, prompt)],
                            device=self.device)
        h1 = self.m["clip"](ids, "penultimate")
        h2, pooled = self.m["clip2"](ids2, "pooled")
        states = torch.cat([h1, h2], dim=-1)
        states[0] = 0.0  # the empty negative prompt, force_zeros_for_empty_prompt
        pooled[0] = 0.0
        return states, pooled

    def denoise(self, requests: Sequence[Dict], lat: torch.Tensor, steps: int, start: int,
                guidance: float) -> torch.Tensor:
        """Visits ``start``..``steps - 1`` of an LMS run of ``steps`` for the
        requests' rows of ``lat`` (N, 4, h, w)."""
        sch = lms_schedule(self.cfg["scheduler"], steps)
        n = len(requests)
        enc = [self.encode(r["prompt"]) for r in requests]
        ctx = torch.cat([e[0][:1] for e in enc] + [e[0][1:] for e in enc])
        weights = []
        for r in requests:
            m, t = regions(self.tok, r, padded_ids(self.tok, r["prompt"]))
            weights.append(pww_weights(m, t, self.device))
        keys = weights[0].keys()
        w_rows = {k: torch.cat([torch.zeros_like(torch.stack([w[k] for w in weights]))]
                               + [torch.stack([w[k] for w in weights])]) for k in keys}
        added = None
        if self.xl:
            h, w = (lat.shape[2] * 8, lat.shape[3] * 8)
            added = {"text_embeds": torch.cat([e[1][:1] for e in enc] + [e[1][1:] for e in enc]),
                     "time_ids": torch.tensor([[h, w, 0, 0, h, w]] * (2 * n),
                                              dtype=torch.float32, device=self.device)}
        state = torch.zeros((LMS_ORDER,) + tuple(lat.shape), device=self.device)
        for i in range(start, steps):
            s = torch.tensor(sch["sigmas"][i], device=self.device)
            x = lat / torch.sqrt(s * s + 1.0)
            coef = 0.1 * torch.log1p(s)
            out = self.m["unet"](torch.cat([x, x]), torch.tensor(sch["timesteps"][i],
                                                                 device=self.device),
                                 ctx, {"weights": w_rows, "coef": coef}, added)
            eps = out[:n] + guidance * (out[n:] - out[:n])
            state = torch.cat([eps[None], state[:-1]])
            for j, c in enumerate(sch["coeffs"][i]):
                if c != 0:
                    lat = lat + float(c) * state[j]
        return lat

    def noise(self, seed: int, h: int, w: int) -> torch.Tensor:
        x = jaxnoise.normal(seed, (1, h, w, 4))
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(self.device)

    def decode(self, lat: torch.Tensor) -> np.ndarray:
        img = self.m["vae"].decode(lat / self.cfg["vae"]["scaling_factor"])
        img = torch.clamp(img / 2 + 0.5, 0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()

    @torch.inference_mode()
    def txt2img(self, requests: Sequence[Dict], steps: int, guidance: float) -> np.ndarray:
        """(N, H, W, 3) uint8 for requests that share one size."""
        H, W = np.asarray(requests[0]["color_map_image"]).shape[:2]
        sch = lms_schedule(self.cfg["scheduler"], steps)
        lat = torch.cat([self.noise(r["seed"], H // 8, W // 8) for r in requests])
        lat = self.denoise(requests, lat * float(sch["init_sigma"]), steps, 0, guidance)
        return self.decode(lat)
