"""The port's schedulers against the JAX package's (CPU, f32 on both sides).

Each kind's trajectory tables must equal the JAX ones exactly (the same f64
numpy code, rounded to f32 once), and its steps must follow the JAX steps
on the same inputs within f32 rounding: the port multiplies f32 tensors by
f32 host scalars where JAX multiplies by f32 device scalars, in the same
order, so the limit is a few ulps of the latents (1e-5 relative to their
largest value, which also covers the summation order of the LMS and PLMS
blends). The stochastic kinds take the noise the JAX step draws from its
key, ``jax.random.normal(k, shape)``, as an argument.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SchedulerConfig as JSchedulerConfig
from pww_tpu.schedulers.schedules import make_scheduler as jax_make_scheduler
from pww_tpu_torch.config import SchedulerConfig
from pww_tpu_torch.schedulers.schedules import KINDS, make_scheduler
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

KARRAS_KINDS = ("lms", "euler", "euler_ancestral", "heun", "dpmpp_2m", "dpmpp_2m_sde",
                "unipc")
CASES = [(k, False) for k in KINDS] + [(k, True) for k in KARRAS_KINDS]
SHAPE = (1, 4, 6, 6)


def schedules(kind, steps, **cfg):
    js = jax_make_scheduler(kind, JSchedulerConfig(**cfg)).set_timesteps(steps)
    ts = make_scheduler(kind, SchedulerConfig(**cfg)).set_timesteps(steps)
    return js, ts


def close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("kind,karras", CASES)
def test_tables_match_jax(kind, karras):
    js, ts = schedules(kind, 7, use_karras_sigmas=karras)
    assert ts.num_steps == js.num_steps and ts.kind == js.kind
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.sigmas.numpy(), np.asarray(js.sigmas))
    np.testing.assert_array_equal(ts.alphas_cumprod_t, np.asarray(js.alphas_cumprod_t))
    np.testing.assert_array_equal(ts.alphas_cumprod_prev, np.asarray(js.alphas_cumprod_prev))
    assert ts.init_noise_sigma == float(js.init_noise_sigma)
    if kind == "lms":
        np.testing.assert_array_equal(ts.lms_coeffs, np.asarray(js.lms_coeffs))
    jt = js.pndm_tables or {}
    assert set(ts.tables) == set(jt)
    for name, table in jt.items():
        np.testing.assert_array_equal(ts.tables[name], np.asarray(table), err_msg=name)


@pytest.mark.parametrize("kind,steps,cfg", [
    ("ddim", 10, dict(steps_offset=1, set_alpha_to_one=False)),
    ("pndm", 10, dict(steps_offset=1)),
    ("pndm", 1, {}),
    ("lms", 1, {}),
])
def test_offsets_and_final_alpha_match_jax(kind, steps, cfg):
    js, ts = schedules(kind, steps, **cfg)
    assert ts.num_steps == js.num_steps
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.alphas_cumprod_prev, np.asarray(js.alphas_cumprod_prev))
    for name, table in (js.pndm_tables or {}).items():
        np.testing.assert_array_equal(ts.tables[name], np.asarray(table), err_msg=name)


@pytest.mark.parametrize("kind,karras", CASES)
def test_steps_match_jax(kind, karras):
    """Every visit of a 5-step trajectory from the init noise, with the
    state carried along: the sample, the state and the ε-to-x0 estimate."""
    js, ts = schedules(kind, 5, use_karras_sigmas=karras)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(SHAPE) * ts.init_noise_sigma).astype(np.float32)
    jx, jstate = jnp.asarray(x), js.init_state(x.shape, jnp.float32)
    tx, tstate = torch.from_numpy(x), ts.init_state(x.shape)
    assert tuple(tstate.shape) == tuple(jstate.shape)
    key = jax.random.PRNGKey(7)
    for i in range(ts.num_steps):
        close(ts.scale_model_input(tx, i), js.scale_model_input(jx, i), f"scale {i}")
        eps = rng.standard_normal(SHAPE).astype(np.float32)
        close(ts.pred_x0(torch.from_numpy(eps), tx, i),
              js.pred_x0(jnp.asarray(eps), jx, i), f"pred_x0 {i}")
        k = jax.random.fold_in(key, i) if js.needs_rng else None
        noise = None if k is None else torch.from_numpy(np.array(jax.random.normal(k, SHAPE)))
        jx, jstate = js.step(jnp.asarray(eps), i, jx, jstate, rng=k)
        tx, tstate = ts.step(torch.from_numpy(eps), i, tx, tstate, noise)
        close(tx.numpy(), jx, f"{kind} visit {i}")
        close(tstate.numpy(), jstate, f"{kind} state after visit {i}")
    assert np.isfinite(tx.numpy()).all()


@pytest.mark.parametrize("kind", ["euler_ancestral", "dpmpp_2m_sde", "lcm"])
def test_stochastic_kinds_need_noise(kind):
    ts = make_scheduler(kind).set_timesteps(3)
    x = torch.zeros(SHAPE)
    assert ts.needs_noise
    with pytest.raises(ValueError, match="noise"):
        ts.step(x, 0, x, ts.init_state(SHAPE))


@pytest.mark.parametrize("kind", ["heun", "pndm", "lms", "unipc"])
def test_visit_of_step_matches_jax(kind):
    js, ts = schedules(kind, 6)
    assert [ts.visit_of_step(s) for s in range(8)] == [js.visit_of_step(s) for s in range(8)]


@pytest.mark.parametrize("kind", ["lms", "heun", "ddim", "unipc"])
def test_v_prediction_to_epsilon_and_add_noise_match_jax(kind):
    """Sigma space (lms, heun) and alpha space (ddim, unipc); with a v that
    encodes a known ε, the conversion must give that ε back."""
    js, ts = schedules(kind, 10)
    rng = np.random.default_rng(1)
    x0, eps = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    i = 3
    x = np.asarray(ts.add_noise(torch.from_numpy(x0), torch.from_numpy(eps), i))
    close(x, js.add_noise(jnp.asarray(x0), jnp.asarray(eps), i), "add_noise")
    a_t = float(ts.alphas_cumprod_t[i])
    if ts.sigma_space:  # v on the VP sample a·x, a = 1/√(1+σ²)
        s = float(ts.sigmas[i])
        a = 1.0 / np.sqrt(1.0 + s * s)
        v = a * eps - s * a * x0
    else:
        v = np.sqrt(a_t) * eps - np.sqrt(1.0 - a_t) * x0
    v = v.astype(np.float32)
    got = ts.to_epsilon(torch.from_numpy(v), torch.from_numpy(x), i, "v_prediction")
    close(got, js.to_epsilon(jnp.asarray(v), jnp.asarray(x), i, "v_prediction"),
          "to_epsilon")
    np.testing.assert_allclose(got.numpy(), eps, atol=1e-4)
    tv = torch.from_numpy(v)
    assert ts.to_epsilon(tv, torch.from_numpy(x), i) is tv  # epsilon: as is
    with pytest.raises(ValueError, match="prediction_type"):
        ts.to_epsilon(torch.from_numpy(v), torch.from_numpy(x), i, "sample")


def test_unknown_and_unported_kinds_raise():
    """Every kind is ported since ROADMAP A.14; LCM refuses more steps than
    its teacher's grid has, as the JAX package does."""
    with pytest.raises(ValueError, match="original_inference_steps"):
        make_scheduler("lcm").set_timesteps(51)
    with pytest.raises(ValueError, match="original_inference_steps"):
        jax_make_scheduler("lcm").set_timesteps(51)
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("dpm_fast")
