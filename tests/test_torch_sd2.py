"""SD-2.x in the port: the SD-2.1 768-v configuration, v-prediction end to
end against the JAX pipeline, and the denoise loop under every scheduler
(CPU, f32 on both sides).

The tiny SD-2-style pipeline has per-block head counts of head dim 8, a
GELU text tower and ``prediction_type="v_prediction"``; its final latents
must follow the JAX pipeline's within the txt2img test's tolerance (f32
summation-order noise, 2e-5 of their largest value) under LMS (sigma
space) and DDIM (alpha space), the two forms of the v-to-ε conversion.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models import unet as tunet
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.schedulers.schedules import make_scheduler
from pww_tpu_torch.weights import loader
from pww_tpu_torch.weights.bridge import build_models, synthetic_params
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401

KWARGS = dict(prompt="a cat and a dog", color_map_image=color_map(128),
              color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
              num_inference_steps=3, seed=0, noise_mode="torch")


def tiny_sd2(cfg):
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, hidden_act="gelu"),
        unet=dataclasses.replace(cfg.unet, attention_head_dim=8,
                                 prediction_type="v_prediction"))


def test_sd21_has_the_published_shapes():
    """diffusers' SD-2.1 parameter counts (UNet, OpenCLIP-H's 23 layers,
    VAE) and head dim 64 at every attention site."""
    cfg = SDModelConfig.sd21()
    counts = {part: sum(t.numel() for t in m.state_dict().values())
              for part, m in build_models(cfg).items()}
    assert counts == {"unet": 865_910_724, "clip": 340_387_840, "vae": 83_653_863}
    assert [cfg.unet.heads_for(c) for c in cfg.unet.block_out_channels] == \
        [(5, 64), (10, 64), (20, 64), (20, 64)]
    assert cfg.unet.prediction_type == "v_prediction" and cfg.unet.sample_size == 96
    assert SDModelConfig.sd21(v_prediction=False).unet.prediction_type == "epsilon"


def test_sd21_diffusers_layout_converts_on_the_meta_device():
    """An SD-2.1 state dict as diffusers stores it (Linear proj_in/proj_out,
    the text encoder's position_ids) converts to the port's full-size
    modules, shapes only."""
    cfg = SDModelConfig.sd21()
    linear = 0
    for part, module in build_models(cfg).items():
        expected = module.state_dict()
        state = {}
        for k, t in expected.items():
            if part == "unet" and k.endswith(("proj_in.weight", "proj_out.weight")) \
                    and "attentions" in k:
                t, linear = t[:, :, 0, 0], linear + 1
            state[k] = t
        if part == "clip":
            state["text_model.embeddings.position_ids"] = torch.empty((1, 77), device="meta")
        out = loader.convert_state_dict(part, state, expected)
        assert {k: tuple(v.shape) for k, v in out.items()} == \
            {k: tuple(v.shape) for k, v in expected.items()}
    assert linear == 2 * 16  # 16 Transformer2D sites


def test_synthetic_params_fill_an_sd2_style_config():
    cfg = tiny_sd2(SDModelConfig.tiny())
    params = synthetic_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    for part, module in build_models(cfg).items():
        assert {k: tuple(v.shape) for k, v in params[part].items()} == \
            {k: tuple(v.shape) for k, v in module.state_dict().items()}
    pipe = PwwPipeline(cfg, params=params, device="cpu", dtype=torch.float32)
    assert pipe.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.heads == 4


@pytest.mark.parametrize("scheduler", ["lms", "ddim"])
def test_tiny_v_prediction_matches_jax(scheduler):
    jp, tp = pipeline_pair(tiny_sd2(JaxSDModelConfig.tiny()), tiny_sd2(SDModelConfig.tiny()),
                           seed=5, scheduler=scheduler)
    want = np.asarray(jp.generate(return_latents=True, **KWARGS))
    got = tp.generate(return_latents=True, **KWARGS)
    assert got.shape == want.shape == (1, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    eps = dataclasses.replace(tp.config, unet=dataclasses.replace(
        tp.config.unet, prediction_type="epsilon"))
    tp.config = eps  # the same weights read as ε: another trajectory
    assert not np.allclose(tp.generate(return_latents=True, **KWARGS), got, atol=1e-3)


@pytest.fixture(scope="module")
def pipe():
    """Weights of std 0.1 rather than 0.02, so that a few steps move the
    latents well away from the initial noise."""
    cfg = tiny_sd2(SDModelConfig.tiny())
    params = synthetic_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    params = {p: {k: v * 5.0 for k, v in sd.items()} for p, sd in params.items()}
    return PwwPipeline(cfg, params=params, device="cpu", dtype=torch.float32)


def run(pipe, kind, monkeypatch, **kw):
    monkeypatch.setattr(pipe, "scheduler", make_scheduler(kind))
    return pipe.generate(return_latents=True, **{**KWARGS, **kw})


@pytest.mark.parametrize("kind,twin", [("euler_ancestral", "euler"),
                                       ("dpmpp_2m_sde", "dpmpp_2m")])
def test_stochastic_kinds_are_seeded_and_differ_from_their_twin(pipe, kind, twin,
                                                                monkeypatch):
    """Their step noise comes from a generator seeded from (seed, 3), not
    from jax.random, so they are held to invariants, not to the JAX run."""
    a, b = run(pipe, kind, monkeypatch), run(pipe, kind, monkeypatch)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, run(pipe, twin, monkeypatch), atol=1e-3)
    assert not np.allclose(a, run(pipe, kind, monkeypatch, seed=1), atol=1e-3)


@pytest.mark.parametrize("kind,steps,visits", [("heun", 3, 5), ("pndm", 3, 4),
                                               ("unipc", 3, 3), ("ddim", 3, 3)])
def test_the_loop_runs_every_visit(pipe, kind, steps, visits, monkeypatch):
    calls = []
    forward = tunet.UNet2DConditionModel.forward

    def counted(self, *a, **k):
        calls.append(1)
        return forward(self, *a, **k)

    monkeypatch.setattr(tunet.UNet2DConditionModel, "forward", counted)
    out = run(pipe, kind, monkeypatch, num_inference_steps=steps)
    assert np.isfinite(out).all()
    assert len(calls) == visits == make_scheduler(kind).set_timesteps(steps).num_steps


@pytest.mark.parametrize("kind", ["pndm", "heun", "unipc", "dpmpp_2m", "dpmpp_2m_sde"])
def test_img2img_strength_truncation_raises_for_multistep_kinds(pipe, kind, monkeypatch):
    init = np.full((128, 128, 3), 128, np.uint8)
    with pytest.raises(ValueError, match="strength truncation"):
        run(pipe, kind, monkeypatch, init_image=init, strength=0.5)
    assert np.isfinite(run(pipe, "euler", monkeypatch, init_image=init, strength=0.5)).all()
