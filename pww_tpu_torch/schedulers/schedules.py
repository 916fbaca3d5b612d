"""The LMS scheduler, trajectory on the host, step on the device.

Port of the LMS part of :mod:`pww_tpu.schedulers.schedules`: diffusers'
``scaled_linear`` betas, the sigma table interpolated at ``num_steps``
evenly spaced train timesteps, and the order-4 LMS coefficients (integrated
Lagrange polynomials, ``scipy.integrate.quad``) computed once per
``set_timesteps``. The step keeps the most recent derivatives only, as many
as the coefficients use (diffusers' ``zip`` truncation of the history).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig

LMS_ORDER = 4


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(
            cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps,
            dtype=np.float64,
        ) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(
            cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=np.float64
        )
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")


def _lms_coefficients(sigmas: np.ndarray, num_steps: int) -> np.ndarray:
    """(num_steps, LMS_ORDER) integrated-Lagrange coefficients, zero-padded."""
    from scipy import integrate

    coeffs = np.zeros((num_steps, LMS_ORDER), dtype=np.float64)
    for t in range(num_steps):
        order = min(t + 1, LMS_ORDER)
        for j in range(order):
            def poly(tau, j=j, order=order, t=t):
                prod = 1.0
                for k in range(order):
                    if k == j:
                        continue
                    prod *= (tau - sigmas[t - k]) / (sigmas[t - j] - sigmas[t - k])
                return prod

            coeffs[t, j] = integrate.quad(
                poly, sigmas[t], sigmas[t + 1], epsrel=1e-4
            )[0]
    return coeffs


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An LMS trajectory: host tables plus their device copies.

    ``sigmas`` has ``num_steps + 1`` entries (the last is 0). Tables are
    rounded to f32, as the JAX package holds them.
    """

    timesteps: torch.Tensor  # (N,) f32 on the device
    sigmas: torch.Tensor  # (N+1,) f32 on the device
    init_noise_sigma: float
    lms_coeffs: np.ndarray  # (N, LMS_ORDER) f32, host
    num_steps: int

    def sigma(self, i: int) -> torch.Tensor:
        return self.sigmas[i]

    def scale_model_input(self, sample: torch.Tensor, i: int) -> torch.Tensor:
        s = self.sigmas[i]
        return sample / torch.sqrt(s * s + 1.0)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             history: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x_t → x_{t-1} for an epsilon prediction; ``history`` holds the
        most recent derivatives first."""
        history = [model_output] + history[: LMS_ORDER - 1]
        order = min(i + 1, LMS_ORDER)
        delta = sum(float(c) * d for c, d in zip(self.lms_coeffs[i, :order], history))
        return sample + delta, history


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """Host-side factory: config → per-call :class:`Schedule`."""

    config: SchedulerConfig = SchedulerConfig()

    def set_timesteps(self, num_steps: int, device="cpu") -> Schedule:
        cfg = self.config
        alphas_cumprod = np.cumprod(1.0 - make_betas(cfg))
        sigmas_full = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
        timesteps = np.linspace(
            0, cfg.num_train_timesteps - 1, num_steps, dtype=np.float64
        )[::-1].copy()
        sigmas = np.interp(timesteps, np.arange(cfg.num_train_timesteps), sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]])
        return Schedule(
            timesteps=torch.tensor(timesteps, dtype=torch.float32, device=device),
            sigmas=torch.tensor(sigmas, dtype=torch.float32, device=device),
            init_noise_sigma=float(np.float32(sigmas.max())),
            lms_coeffs=_lms_coefficients(sigmas, num_steps).astype(np.float32),
            num_steps=num_steps,
        )


def make_scheduler(kind: str = "lms",
                   config: SchedulerConfig = SchedulerConfig()) -> Scheduler:
    if kind != "lms":
        raise NotImplementedError(
            f"scheduler {kind!r}: the port has the LMS scheduler only so far"
        )
    return Scheduler(config=config)
