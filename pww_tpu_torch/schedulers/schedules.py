"""Diffusion schedulers: trajectory tables on the host, step on the device.

Port of :mod:`pww_tpu.schedulers.schedules`:
diffusers' ``scaled_linear`` betas; ``lms`` (order-4 integrated-Lagrange
coefficients, ``scipy.integrate.quad``), ``euler``, ``euler_ancestral`` and
``heun`` in sigma space; ``ddim``, ``pndm`` (PLMS), ``dpmpp_2m``,
``dpmpp_2m_sde``, ``unipc`` and ``lcm`` (Latent Consistency Models) in
alpha space; Karras ρ=7 spacing with
``SchedulerConfig.use_karras_sigmas``. Every per-step coefficient is
computed once per ``set_timesteps`` into f32 numpy tables, as the JAX
package holds them, so the device step is plain arithmetic on the latents
with host scalars.

The scheduler state is one f32 tensor of stacked rows, zero at the start
(:meth:`Schedule.init_state`): LMS's derivative history, PLMS's eps history
and warm-up sample, the previous x0 of DPM-Solver++, UniPC's two x0
predictions and corrected sample, Heun's step start. A zero LMS history
contributes zero terms, which is diffusers' truncation of the history at
the first steps and at an img2img start. ``heun`` and ``pndm`` visit some
steps twice, so a loop runs over ``num_steps`` visits, not the requested
steps. ``euler_ancestral``, ``dpmpp_2m_sde`` and ``lcm`` take fresh noise
each step as an argument of :meth:`Schedule.step`, drawn by
:func:`step_noise` from the JAX package's stream; LCM's last step returns
the denoised sample and ignores it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..conditioning.seeding import normal_nchw
from ..config import SchedulerConfig
from ..utils import jax_random

LMS_ORDER = 4
SIGMA_KINDS = ("lms", "euler", "euler_ancestral", "heun")
ALPHA_KINDS = ("ddim", "pndm", "dpmpp_2m", "dpmpp_2m_sde", "unipc", "lcm")
KINDS = SIGMA_KINDS + ALPHA_KINDS
# state rows per kind (pndm: 4 eps + the warm-up sample; unipc: x0 at i-1 and
# i-2, the corrected sample at i-1; heun: the step's start and derivative)
_STATE_ROWS = {"lms": LMS_ORDER, "pndm": 5, "dpmpp_2m": 1, "dpmpp_2m_sde": 1,
               "unipc": 3, "heun": 2}
_f32 = np.float32


# the stochastic kinds' step-noise stream is PRNGKey(seed ^ STEP_SEED_XOR)
STEP_SEED_XOR = 0x5EED


def step_noise(seeds, i: int, shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """The stochastic kinds' fresh f32 noise at visit ``i`` for (N, C, h, w)
    latents, the JAX package's draws (``pww_tpu/pipeline/pipeline.py:
    157-162``, ``pww_tpu/schedulers/schedules.py:91-101``): the seeds split
    the N rows evenly (one seed for ``num_samples`` rows, one a request for
    ``generate_batch``), and each draws its rows NHWC from
    ``fold_in(PRNGKey(seed ^ 0x5EED), i)``. jax's bits depend only on the
    key and the flat index, so a request's row in a batch draws what the
    request served alone draws."""
    n, c, h, w = shape
    rows = n // len(seeds)
    return torch.cat([normal_nchw(jax_random.fold_in(
        jax_random.PRNGKey(int(s) ^ STEP_SEED_XOR), i), (rows, c, h, w), device)
        for s in seeds])


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


def _karras_sigmas(sigmas: np.ndarray, sigmas_full: np.ndarray, num_steps: int,
                   rho: float = 7.0) -> Tuple[np.ndarray, np.ndarray]:
    """Karras et al. (2022) ρ-spaced sigmas over the same [σ_min, σ_max], with
    timesteps re-derived by log-sigma interpolation (diffusers
    ``_convert_to_karras`` / ``_sigma_to_t``)."""
    s_max, s_min = float(sigmas[0]), float(sigmas[-1])
    ramp = np.linspace(0.0, 1.0, num_steps)
    new_sigmas = (
        s_max ** (1.0 / rho) + ramp * (s_min ** (1.0 / rho) - s_max ** (1.0 / rho))
    ) ** rho
    timesteps = np.interp(np.log(new_sigmas), np.log(sigmas_full),
                          np.arange(len(sigmas_full), dtype=np.float64))
    return new_sigmas, timesteps


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A trajectory: device copies of the timesteps and sigmas, f32 host
    tables for the step.

    ``sigmas`` has ``num_steps + 1`` entries (the last is 0); every kind has
    them, for the PwW weight function's σ. ``num_steps`` counts visits of
    the denoise loop (``heun``: 2·N − 1, ``pndm``: N + 1).
    """

    kind: str
    timesteps: torch.Tensor  # (V,) f32 on the device
    sigmas: torch.Tensor  # (V+1,) f32 on the device
    init_noise_sigma: float
    num_steps: int
    sigmas_host: np.ndarray  # (V+1,) f32
    alphas_cumprod_t: np.ndarray  # (V,) f32: ᾱ at each visit's timestep
    alphas_cumprod_prev: np.ndarray  # (V,) f32: ᾱ at the next visit's
    lms_coeffs: Optional[np.ndarray] = None  # (V, LMS_ORDER) f32
    tables: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    # -- the uniform interface ---------------------------------------------------
    def visit_of_step(self, step: int) -> int:
        """The loop visit at which requested step ``step`` (0-based) begins:
        heun runs two visits per step but one at the last, pndm runs its
        second step twice; 1:1 for the others. ``step == N`` maps to
        ``num_steps``."""
        if self.kind == "heun":
            return min(max(2 * step - 1, 0), self.num_steps)
        if self.kind == "pndm":
            return min(step if step <= 1 else step + 1, self.num_steps)
        return min(step, self.num_steps)

    @property
    def needs_noise(self) -> bool:
        """Kinds whose :meth:`step` takes fresh noise."""
        return self.kind in ("euler_ancestral", "dpmpp_2m_sde", "lcm")

    @property
    def sigma_space(self) -> bool:
        """Samples are x0 + σ·ε (else √ᾱ·x0 + √(1−ᾱ)·ε)."""
        return self.kind in SIGMA_KINDS

    def sigma(self, i: int) -> torch.Tensor:
        return self.sigmas[i]

    def _t(self, name: str, i: int) -> np.float32:
        return self.tables[name][i]

    def _alpha(self, i: int) -> Tuple[np.float32, np.float32]:
        """(√ᾱ_t, √(1−ᾱ_t)) in f32."""
        a_t = self.alphas_cumprod_t[i]
        return np.sqrt(a_t), np.sqrt(_f32(1.0) - a_t)

    def scale_model_input(self, sample: torch.Tensor, i: int) -> torch.Tensor:
        if self.sigma_space:
            s = self.sigmas[i].to(sample.dtype)
            return sample / torch.sqrt(s * s + 1.0)
        return sample

    def to_epsilon(self, model_output: torch.Tensor, sample: torch.Tensor, i: int,
                   prediction_type: str = "epsilon") -> torch.Tensor:
        """A model output in the ε convention; a v prediction (SD-2.x 768-v)
        converts by the sample's space."""
        if prediction_type == "epsilon":
            return model_output
        if prediction_type != "v_prediction":
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        v, x = model_output.float(), sample.float()
        if self.sigma_space:
            s = self.sigmas_host[i]
            denom = s * s + _f32(1.0)
            pred_x0 = float(-s) * v / float(np.sqrt(denom)) + x / float(denom)
            eps = (x - pred_x0) / float(s)
        else:
            sa, sb = self._alpha(i)
            eps = float(sa) * v + float(sb) * x
        return eps.to(model_output.dtype)

    def pred_x0(self, eps: torch.Tensor, sample: torch.Tensor, i: int) -> torch.Tensor:
        """The denoised estimate an ε prediction implies at visit i (the
        inverse of :meth:`add_noise`)."""
        x, e = sample.float(), eps.float()
        if self.sigma_space:
            return x - float(self.sigmas_host[i]) * e
        sa, sb = self._alpha(i)
        return (x - float(sb) * e) / float(sa)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, i: int) -> torch.Tensor:
        """The sample at visit i's noise level."""
        if self.sigma_space:
            return original + noise * self.sigmas[i].to(original.dtype)
        sa, sb = self._alpha(i)
        return (float(sa) * original.float() + float(sb) * noise.float()).to(original.dtype)

    def init_state(self, shape, device="cpu") -> torch.Tensor:
        """The zero state, (rows, *shape) f32."""
        rows = _STATE_ROWS.get(self.kind, 0)
        return torch.zeros((rows,) + tuple(shape), dtype=torch.float32, device=device)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             state: torch.Tensor, noise: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x at visit i → x at visit i + 1, for an ε prediction; ``noise``
        (the sample's shape) for the kinds that need it."""
        if self.needs_noise and noise is None:
            raise ValueError(f"{self.kind} takes fresh noise every step (noise=...)")
        return getattr(self, "_step_" + self.kind)(model_output, i, sample, state, noise)

    # -- the steps, one per kind (pww_tpu/schedulers/schedules.py:195-386) -------
    def _step_lms(self, mo, i, sample, state, noise):
        state = torch.cat([mo[None].to(state.dtype), state[:-1]])
        delta = None
        for j, c in enumerate(self.lms_coeffs[i]):
            if c != 0:
                term = float(c) * state[j]
                delta = term if delta is None else delta + term
        return sample + delta, state

    def _step_euler(self, mo, i, sample, state, noise):
        dt = self.sigmas_host[i + 1] - self.sigmas_host[i]
        return sample + mo * float(dt), state

    def _step_euler_ancestral(self, mo, i, sample, state, noise):
        sig, nxt = self.sigmas_host[i], self.sigmas_host[i + 1]
        var = nxt * nxt * (sig * sig - nxt * nxt) / (sig * sig)
        up = np.sqrt(max(var, _f32(0.0)))
        down = np.sqrt(max(nxt * nxt - up * up, _f32(0.0)))
        prev = sample + mo * float(down - sig)
        return prev + noise.to(sample.dtype) * float(up), state

    def _step_pndm(self, mo, i, sample, state, noise):
        # eps' = a·eps + Σ_j c_j·ets_j (Adams–Bashforth blend);
        # x_prev = sc·x − ad·eps' / dn
        ets, cur = state[:4], state[4]
        if self._t("push", i) > 0:
            ets = torch.cat([mo[None].to(state.dtype), ets[:-1]])
        new_cur = sample if self._t("set_cur", i) > 0 else cur
        eps = float(self._t("a", i)) * mo
        for j, c in enumerate(self.tables["c"][i]):
            eps = eps + float(c) * ets[j]
        base = cur if self._t("use_cur", i) > 0 else sample
        prev = (float(self._t("sample_coeff", i)) * base
                - float(self._t("alpha_diff", i)) * eps / float(self._t("denom", i)))
        return prev.to(sample.dtype), torch.cat([ets, new_cur[None].to(state.dtype)])

    def _dpmpp(self, mo, i, sample, state, noise):
        x = sample.float()
        x0 = (x - float(self._t("sigma_t", i)) * mo.float()) / float(self._t("alpha_t", i))
        d = float(self._t("c0", i)) * x0 + float(self._t("c1", i)) * state[0].float()
        prev = float(self._t("x_coeff", i)) * x + float(self._t("d_coeff", i)) * d
        if noise is not None:
            prev = prev + float(self._t("n_coeff", i)) * noise.float()
        return prev.to(sample.dtype), torch.cat([x0[None].to(state.dtype), state[1:]])

    def _step_dpmpp_2m(self, mo, i, sample, state, noise):
        return self._dpmpp(mo, i, sample, state, None)

    def _step_dpmpp_2m_sde(self, mo, i, sample, state, noise):
        return self._dpmpp(mo, i, sample, state, noise)

    def _step_heun(self, mo, i, sample, state, noise):
        # an Euler predictor at σ_i, then a trapezoidal corrector at σ_{i+1};
        # the last (σ → 0) step is Euler only
        dt = float(self._t("dt", i))
        x, d = sample.float(), mo.float()
        if self._t("second", i) > 0:
            prev = state[0].float() + 0.5 * (state[1].float() + d) * dt
            return prev.to(sample.dtype), state
        return (x + d * dt).to(sample.dtype), torch.stack([x, d]).to(state.dtype)

    def _step_ddim(self, mo, i, sample, state, noise):
        sa, sb = self._alpha(i)
        a_prev = self.alphas_cumprod_prev[i]
        x, eps = sample.float(), mo.float()
        x0 = (x - float(sb) * eps) / float(sa)
        prev = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(_f32(1.0) - a_prev)) * eps
        return prev.to(sample.dtype), state

    def _step_lcm(self, mo, i, sample, state, noise):
        # the consistency function f = c_out·x0 + c_skip·x, re-noised to the
        # next visit's level with fresh noise, except at the last visit
        sa, sb = self._alpha(i)
        x, eps = sample.float(), mo.float()
        x0 = (x - float(sb) * eps) / float(sa)
        denoised = float(self._t("c_out", i)) * x0 + float(self._t("c_skip", i)) * x
        if self._t("is_last", i) > 0:
            return denoised.to(sample.dtype), state
        a_prev = self.alphas_cumprod_prev[i]
        prev = (float(np.sqrt(a_prev)) * denoised
                + float(np.sqrt(_f32(1.0) - a_prev)) * noise.float())
        return prev.to(sample.dtype), state

    def _step_unipc(self, mo, i, sample, state, noise):
        # UniC corrector on the current sample (from the previous corrected
        # one and the new x0), then the UniP predictor to the next visit;
        # products of two table entries are taken in f32, as on the device
        t = lambda name: self._t(name, i)  # noqa: E731
        x, eps = sample.float(), mo.float()
        a_i, s_i = t("alpha_t"), t("sigma_t")
        m_raw = (x - float(s_i) * eps) / float(a_i)
        m1, m2, x_prev = state[0].float(), state[1].float(), state[2].float()
        if t("use_corr") > 0:
            d1_hist = (m2 - m1) * float(t("c_inv_r"))
            x_c = float(t("c_ratio")) * x_prev - float(a_i * t("c_hphi1")) * m1
            x = x_c - float(a_i * t("c_bh")) * (float(t("c_rho_hist")) * d1_hist
                                                + float(t("c_rho_new")) * (m_raw - m1))
        m = (x - float(s_i) * eps) / float(a_i)
        d1_p = (m1 - m) * float(t("p_inv_r"))
        an = t("p_alpha_next")
        prev = (float(t("p_ratio")) * x - float(an * t("p_hphi1")) * m
                - float(an * t("p_bh") * t("p_rho")) * d1_p)
        return prev.to(sample.dtype), torch.stack([m, m1, x]).to(state.dtype)


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """Host-side factory: config + kind → per-call :class:`Schedule`."""

    config: SchedulerConfig = SchedulerConfig()
    kind: str = "lms"

    def set_timesteps(self, num_steps: int, device="cpu") -> Schedule:
        cfg = self.config
        alphas_cumprod = np.cumprod(1.0 - make_betas(cfg))
        sigmas_full = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
        lms = None
        if self.kind in SIGMA_KINDS:
            timesteps = np.linspace(
                0, cfg.num_train_timesteps - 1, num_steps, dtype=np.float64
            )[::-1].copy()
            sigmas = np.interp(timesteps, np.arange(cfg.num_train_timesteps), sigmas_full)
            if cfg.use_karras_sigmas:
                sigmas, timesteps = _karras_sigmas(sigmas, sigmas_full, num_steps)
            if self.kind == "heun":
                return self._heun(sigmas, timesteps, alphas_cumprod, device)
            sigmas = np.concatenate([sigmas, [0.0]])
            init_noise_sigma = sigmas.max()
            if self.kind == "lms":
                lms = _lms_coefficients(sigmas, num_steps)
            t_int = np.round(timesteps).astype(np.int64)
        elif self.kind == "ddim":
            step_ratio = cfg.num_train_timesteps // num_steps
            t_int = (np.arange(num_steps) * step_ratio).round()[::-1].copy()
            t_int = (t_int + cfg.steps_offset).astype(np.int64)
            timesteps = t_int.astype(np.float64)
            sigmas = np.sqrt((1.0 - alphas_cumprod[t_int]) / alphas_cumprod[t_int])
            sigmas = np.concatenate([sigmas, [0.0]])
            init_noise_sigma = 1.0
        elif self.kind == "pndm":
            return self._pndm(num_steps, alphas_cumprod, device)
        elif self.kind in ("dpmpp_2m", "dpmpp_2m_sde"):
            return self._dpmpp(num_steps, alphas_cumprod, device)
        elif self.kind == "unipc":
            return self._unipc(num_steps, alphas_cumprod, device)
        elif self.kind == "lcm":
            return self._lcm(num_steps, alphas_cumprod, device)
        else:
            raise ValueError(f"unknown scheduler kind {self.kind!r}")

        a_t = alphas_cumprod[np.clip(t_int, 0, cfg.num_train_timesteps - 1)]
        t_prev = np.concatenate([t_int[1:], [-1]])
        final_alpha = 1.0 if cfg.set_alpha_to_one else alphas_cumprod[0]
        a_prev = np.where(t_prev >= 0, alphas_cumprod[np.maximum(t_prev, 0)], final_alpha)
        return self._schedule(timesteps, sigmas, init_noise_sigma, a_t, a_prev, num_steps,
                              device, lms_coeffs=lms)

    def _schedule(self, timesteps, sigmas, init_noise_sigma, a_t, a_prev, num_steps,
                  device, lms_coeffs=None, tables=None) -> Schedule:
        """Every table rounded to f32, as the JAX package holds them."""
        sig = np.asarray(sigmas, _f32)
        return Schedule(
            kind=self.kind,
            timesteps=torch.tensor(np.asarray(timesteps, _f32), device=device),
            sigmas=torch.tensor(sig, device=device),
            init_noise_sigma=float(_f32(init_noise_sigma)),
            num_steps=num_steps,
            sigmas_host=sig,
            alphas_cumprod_t=np.asarray(a_t, _f32),
            alphas_cumprod_prev=np.asarray(a_prev, _f32),
            lms_coeffs=None if lms_coeffs is None else np.asarray(lms_coeffs, _f32),
            tables={k: np.asarray(v, _f32) for k, v in (tables or {}).items()},
        )

    def _heun(self, sigmas, timesteps, alphas_cumprod, device) -> Schedule:
        """Each step becomes (predictor at σ_i, corrector at σ_{i+1}); the
        final σ → 0 step is Euler only: 2·N − 1 visits."""
        n = len(sigmas)
        sig = np.concatenate([sigmas, [0.0]])
        visit_sigma, visit_t, dt, second = [], [], [], []
        for i in range(n):
            s_cur, s_next = sig[i], sig[i + 1]
            visit_sigma.append(s_cur)
            visit_t.append(timesteps[i])
            dt.append(s_next - s_cur)
            second.append(0.0)
            if s_next > 0:
                visit_sigma.append(s_next)
                visit_t.append(timesteps[i + 1] if i + 1 < n else 0.0)
                dt.append(s_next - s_cur)
                second.append(1.0)
        visit_sigma = np.asarray(visit_sigma)
        t_int = np.clip(np.round(np.asarray(visit_t)).astype(np.int64), 0,
                        self.config.num_train_timesteps - 1)
        a_t = alphas_cumprod[t_int]
        return self._schedule(visit_t, np.concatenate([visit_sigma, [0.0]]),
                              visit_sigma.max(), a_t, a_t, len(visit_sigma), device,
                              tables={"dt": dt, "second": second})

    def _pndm(self, num_steps, alphas_cumprod, device) -> Schedule:
        """PLMS: the second timestep is visited twice (the pseudo improved-
        Euler warm-up from the original sample), then 2nd/3rd/4th-order
        Adams–Bashforth blends of the eps history; the final ᾱ_prev is ᾱ[0]."""
        cfg = self.config
        ratio = cfg.num_train_timesteps // num_steps
        base = (np.arange(num_steps) * ratio).round().astype(np.int64) + cfg.steps_offset
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        n = len(plms)
        t_cur = plms.astype(np.int64).copy()
        t_prev = t_cur - ratio
        if n > 1:  # the warm-up refinement: step 0's (t, t_prev) pair again
            t_prev[1] = t_cur[1]
            t_cur[1] = t_cur[1] + ratio
        top = cfg.num_train_timesteps - 1
        a_t = alphas_cumprod[np.clip(t_cur, 0, top)]
        a_prev = np.where(t_prev >= 0, alphas_cumprod[np.clip(t_prev, 0, top)],
                          alphas_cumprod[0])
        a = np.zeros(n)
        c = np.zeros((n, 4))
        push, use_cur, set_cur = np.ones(n), np.zeros(n), np.zeros(n)
        for i in range(n):
            if i == 0:
                c[i, 0] = 1.0
                set_cur[i] = 1.0
            elif i == 1:
                push[i], a[i], c[i, 0], use_cur[i] = 0.0, 0.5, 0.5, 1.0
            elif i == 2:
                c[i, :2] = (1.5, -0.5)
            elif i == 3:
                c[i, :3] = np.array([23.0, -16.0, 5.0]) / 12.0
            else:
                c[i, :4] = np.array([55.0, -59.0, 37.0, -9.0]) / 24.0
        tables = {
            "a": a, "c": c, "push": push, "use_cur": use_cur, "set_cur": set_cur,
            "sample_coeff": np.sqrt(a_prev / a_t),
            "denom": a_t * np.sqrt(1.0 - a_prev) + np.sqrt(a_t * (1.0 - a_t) * a_prev),
            "alpha_diff": a_prev - a_t,
        }
        sigmas = np.sqrt((1.0 - a_t) / a_t)
        return self._schedule(plms, np.concatenate([sigmas, [0.0]]), 1.0, a_t, a_prev, n,
                              device, tables=tables)

    def _alpha_trajectory(self, num_steps, alphas_cumprod):
        """(timesteps, ᾱ_t, ᾱ_next) of the multistep solvers: diffusers'
        ``linspace(0, T−1, N+1).round()[::-1][:-1]`` (the trailing t = 0
        dropped, the final ᾱ_next exactly 1), or the Karras ramp."""
        cfg = self.config
        t_int = np.linspace(0, cfg.num_train_timesteps - 1, num_steps + 1
                            ).round().astype(np.int64)[::-1][:-1].copy()
        if cfg.use_karras_sigmas:
            full = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
            sig, ts = _karras_sigmas(full[t_int], full, num_steps)
            ac = 1.0 / (1.0 + sig ** 2)
        else:
            ts = t_int.astype(np.float64)
            ac = alphas_cumprod[t_int]
        return ts, ac, np.concatenate([ac[1:], [1.0]])

    def _dpmpp(self, num_steps, alphas_cumprod, device) -> Schedule:
        """DPM-Solver++ 2M in λ = log(α/σ), x0 prediction; first and last
        steps first order. The SDE kind replaces the deterministic
        coefficients by the exact OU transition
        x' = (σ'/σ)e^{−h}·x + α'(1−e^{−2h})·D + σ'√(1−e^{−2h})·z."""
        t_float, ac_t, ac_p = self._alpha_trajectory(num_steps, alphas_cumprod)
        alpha_t, sigma_t = np.sqrt(ac_t), np.sqrt(1 - ac_t)
        alpha_p, sigma_p = np.sqrt(ac_p), np.sqrt(1 - ac_p)
        lam_t = np.log(alpha_t) - np.log(sigma_t)
        lam_p = np.log(alpha_p) - np.log(np.maximum(sigma_p, 1e-38))
        h = lam_p - lam_t
        h_last = np.concatenate([[np.nan], h[:-1]])
        if self.kind == "dpmpp_2m_sde":
            x_coeff = (sigma_p / sigma_t) * np.exp(-h)
            d_coeff = -alpha_p * np.expm1(-2.0 * h)
            n_coeff = sigma_p * np.sqrt(np.maximum(-np.expm1(-2.0 * h), 0.0))
        else:
            x_coeff = sigma_p / sigma_t
            d_coeff = -alpha_p * (np.exp(-h) - 1.0)
            n_coeff = np.zeros(num_steps)
        c0, c1 = np.ones(num_steps), np.zeros(num_steps)
        for i in range(1, num_steps - 1):
            r = h_last[i] / h[i]
            c0[i] = 1.0 + 1.0 / (2.0 * r)
            c1[i] = -1.0 / (2.0 * r)
        sigmas = np.sqrt((1 - ac_t) / ac_t)
        tables = {"alpha_t": alpha_t, "sigma_t": sigma_t, "x_coeff": x_coeff,
                  "d_coeff": d_coeff, "c0": c0, "c1": c1, "n_coeff": n_coeff}
        return self._schedule(t_float, np.concatenate([sigmas, [0.0]]), 1.0, ac_t, ac_p,
                              num_steps, device, tables=tables)

    def _unipc(self, num_steps, alphas_cumprod, device) -> Schedule:
        """UniPC-2 (``bh2``, x0 prediction, lower order at the first and last
        steps): the corrector and predictor coefficients of each step, from
        the λ trajectory alone."""
        t_float, ac, ac_n = self._alpha_trajectory(num_steps, alphas_cumprod)
        alpha, sigma = np.sqrt(ac), np.sqrt(1 - ac)
        alpha_n, sigma_n = np.sqrt(ac_n), np.sqrt(1 - ac_n)
        lam = np.log(alpha) - np.log(sigma)
        lam_n = np.log(alpha_n) - np.log(np.maximum(sigma_n, 1e-12))
        h_p = lam_n - lam
        hh_p = -h_p
        p_rho = np.full(num_steps, 0.5)
        p_rho[0] = 0.0
        if num_steps > 1:
            p_rho[-1] = 0.0
        p_inv_r = np.zeros(num_steps)
        for i in range(1, num_steps):
            if h_p[i] == 0:
                continue  # a degenerate no-op transition (duplicate timestep)
            r1 = (lam[i - 1] - lam[i]) / h_p[i]
            p_inv_r[i] = 1.0 / r1 if r1 != 0 else 0.0
        names = ("use_corr", "c_ratio", "c_hphi1", "c_bh", "c_rho_hist", "c_rho_new",
                 "c_inv_r")
        corr = {k: np.zeros(num_steps) for k in names}
        for i in range(1, num_steps):
            h = lam[i] - lam[i - 1]
            hh = -h
            phi1 = np.expm1(hh)
            corr["use_corr"][i] = 1.0
            corr["c_ratio"][i] = sigma[i] / sigma[i - 1]
            corr["c_hphi1"][i] = phi1
            corr["c_bh"][i] = phi1
            if i == 1:
                corr["c_rho_new"][i] = 0.5
            else:
                r = (lam[i - 2] - lam[i - 1]) / h
                corr["c_inv_r"][i] = 1.0 / r if r != 0 else 0.0
                phi2 = phi1 / hh - 1.0
                phi3 = phi2 / hh - 0.5
                rho = np.linalg.solve(np.array([[1.0, 1.0], [r, 1.0]]),
                                      np.array([phi2 / phi1, 2.0 * phi3 / phi1]))
                corr["c_rho_hist"][i], corr["c_rho_new"][i] = rho[0], rho[1]
        tables = {"alpha_t": alpha, "sigma_t": sigma, "p_ratio": sigma_n / sigma,
                  "p_alpha_next": alpha_n, "p_hphi1": np.expm1(hh_p), "p_bh": np.expm1(hh_p),
                  "p_rho": p_rho, "p_inv_r": p_inv_r, **corr}
        sigmas = np.sqrt((1 - ac) / ac)
        return self._schedule(t_float, np.concatenate([sigmas, [0.0]]), 1.0, ac, ac_n,
                              num_steps, device, tables=tables)


    def _lcm(self, num_steps, alphas_cumprod, device) -> Schedule:
        """LCM (diffusers' ``LCMScheduler.set_timesteps``): an evenly skipped
        descending subset of the teacher's ``original_inference_steps``-point
        grid k·j − 1 (k = T / orig), and the boundary scalings c_skip, c_out
        at ``timestep_scaling``·t (``pww_tpu/schedulers/schedules.py:531-575``)."""
        cfg = self.config
        orig = cfg.original_inference_steps
        if num_steps > orig:
            raise ValueError(f"lcm: num_steps ({num_steps}) must be <= "
                             f"original_inference_steps ({orig})")
        k = cfg.num_train_timesteps // orig
        origin = np.arange(1, orig + 1, dtype=np.int64) * k - 1
        t_int = origin[::-1][::len(origin) // num_steps][:num_steps].copy()
        a_t = alphas_cumprod[t_int]
        a_prev = alphas_cumprod[np.concatenate([t_int[1:], [t_int[-1]]])]  # last unused
        is_last = np.zeros(num_steps)
        is_last[-1] = 1.0
        st = cfg.timestep_scaling * t_int.astype(np.float64)
        tables = {"c_skip": cfg.sigma_data ** 2 / (st ** 2 + cfg.sigma_data ** 2),
                  "c_out": st / np.sqrt(st ** 2 + cfg.sigma_data ** 2), "is_last": is_last}
        sigmas = np.sqrt((1.0 - a_t) / a_t)  # the PwW weight function's σ
        return self._schedule(t_int, np.concatenate([sigmas, [0.0]]), 1.0, a_t, a_prev,
                              num_steps, device, tables=tables)


def t_start_from_strength(num_steps: int, strength: float, offset: int = 0) -> int:
    """The first step of an img2img run (reference ``paint_with_words.py:435-440``)."""
    init_timestep = min(int(num_steps * strength) + offset, num_steps)
    return max(num_steps - init_timestep + offset, 0)


def make_scheduler(kind: str = "lms",
                   config: SchedulerConfig = SchedulerConfig()) -> Scheduler:
    if kind not in KINDS:
        raise ValueError(f"unknown scheduler kind {kind!r}; the port has {KINDS}")
    return Scheduler(config=config, kind=kind)
