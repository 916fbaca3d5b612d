"""LCM, the hires fix, DeepCache on SDXL and the prompt-editing parser in the
port against the JAX package (CPU, f32 on both sides).

* LCM: the 4-step grid and its tables (the step itself is in
  ``tests/test_torch_schedulers.py``, with the noise the JAX step draws),
  the guidance-scale embedding, ``time_embedding.cond_proj`` in one UNet
  call, and a 1-step LCM pipeline end to end: LCM's last step returns the
  denoised sample without noise, so the JAX pipeline's ``jax.random`` step
  noise (ROADMAP C.5) takes no part; the 4-step run is held to invariants;
* ``generate_hires`` in both upscale modes (the image mode with the
  posterior mean), on the images;
* DeepCache on the tiny SDXL UNet (ROADMAP A.16c), alone and through
  ``generate_batch``;
* the prompt-editing parser over the strings of
  ``tests/test_prompt_editing.py``;
* ``chip_smoke.py``'s launches per visit for the extras, against SD-1.5
  traced on the meta device.

Tolerances: one UNet call within 1e-5 of its largest output; latents within
2e-5 of the largest; uint8 images within one level on 2% of the pixels
(f32 sums in another order round across a .5 boundary now and then).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.conditioning import prompt_editing as jax_editing
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.pipeline.pipeline import guidance_scale_embedding as jax_guidance_embedding
from pww_tpu_torch.conditioning import prompt_editing
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline.pipeline import guidance_scale_embedding
from pww_tpu_torch.schedulers.schedules import make_scheduler
from pww_tpu_torch.weights import loader
from pww_tpu_torch.weights.bridge import synthetic_params
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401

LAT_TOL = 2e-5
KW = dict(prompt="a cat and a dog", color_map_image=color_map(64),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"}, seed=0)


def _lcm(cfg, dim=32):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, time_cond_proj_dim=dim))


@pytest.fixture(scope="module")
def lcm_pair():
    return pipeline_pair(_lcm(JaxSDModelConfig.tiny()), _lcm(SDModelConfig.tiny()), seed=31,
                         scheduler="lcm")


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=32)


def _close_images(got, want, share=2e-2):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


# -- LCM ----------------------------------------------------------------------------------

def test_lcm_grid_and_tables():
    """diffusers' LCMScheduler grid: k = 1000 / 50 = 20, the descending grid
    999, 979, ... skipped by 50 // 4 = 12 (``tests/test_schedulers.py``)."""
    sch = make_scheduler("lcm").set_timesteps(4)
    np.testing.assert_array_equal(sch.timesteps.numpy(), [999.0, 759.0, 519.0, 279.0])
    assert sch.tables["is_last"].tolist() == [0.0, 0.0, 0.0, 1.0]
    st = 10.0 * np.array([999.0, 759.0, 519.0, 279.0])
    np.testing.assert_allclose(sch.tables["c_skip"], 0.25 / (st ** 2 + 0.25), rtol=1e-6)
    np.testing.assert_allclose(sch.tables["c_out"], st / np.sqrt(st ** 2 + 0.25), rtol=1e-6)
    assert sch.needs_noise and not sch.sigma_space


@pytest.mark.parametrize("w,dim", [(8.0, 32), (1.0, 256), (2.5, 33)])
def test_guidance_scale_embedding_matches_jax(w, dim):
    want = np.asarray(jax_guidance_embedding(w, dim))
    got = guidance_scale_embedding(w, dim).numpy()
    assert got.shape == (dim,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_cond_proj_matches_jax(lcm_pair):
    """One LCM UNet call: the embedded guidance scale through ``cond_proj``
    into the timestep embedding; the call without it raises as in JAX."""
    jp, tp = lcm_pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    cond = np.stack([np.asarray(jax_guidance_embedding(w, 32)) for w in (3.0, 8.0)])
    unet = JaxUNet(jp.config.unet, dtype=jnp.float32)
    want = jax.jit(lambda p, x, c, e: unet.apply(p, x, jnp.float32(499.0), c,
                                                 added_cond={"timestep_cond": e}))(
        jp.params["unet"], jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(cond))
    assert tp.unet.time_embedding.cond_proj.weight.shape == (32, 32)
    with torch.inference_mode():
        got = tp.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(499.0),
                      torch.from_numpy(ctx), added_cond={"timestep_cond": torch.from_numpy(cond)})
        with pytest.raises(ValueError, match="time_cond_proj_dim"):
            tp.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(499.0),
                    torch.from_numpy(ctx))
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-4)  # w reaches the UNet


def test_lcm_one_step_pipeline_matches_jax(lcm_pair):
    """One LCM step is deterministic (no step noise): the whole pipeline
    against the JAX one, at two guidance scales, which differ."""
    jp, tp = lcm_pair
    outs = []
    for g in (8.0, 2.0):
        kw = dict(KW, num_inference_steps=1, guidance_scale=g, return_latents=True)
        want = np.asarray(jp.generate(noise_mode="torch", **kw))
        got = tp.generate(noise_mode="torch", **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())
        outs.append(got)
    assert not np.allclose(outs[0], outs[1], atol=1e-4)


def test_lcm_four_steps_and_batch(lcm_pair):
    """Four steps draw fresh noise per step from the seed's side stream:
    finite, deterministic, unlike the 1-step result; ``generate_batch``'s
    row 0 is the request alone."""
    _, tp = lcm_pair
    kw = dict(KW, num_inference_steps=4, guidance_scale=8.0)
    four = tp.generate(return_latents=True, **kw)
    assert np.isfinite(four).all() and four.shape == (1, 8, 8, 4)
    np.testing.assert_array_equal(four, tp.generate(return_latents=True, **kw))
    assert not np.allclose(four, tp.generate(return_latents=True,
                                             **dict(kw, num_inference_steps=1)), atol=1e-3)
    reqs = [KW, dict(KW, seed=5, prompt="a fox and a dog")]
    batch = tp.generate_batch(reqs, num_inference_steps=4, guidance_scale=8.0, output_type="np")
    _close_images(batch[0], tp.generate(output_type="np", **kw)[0])


def test_lcm_unet_round_trips_through_a_directory(lcm_pair, tmp_path):
    """``time_cond_proj_dim`` is written to and read from ``unet/config.json``."""
    _, tp = lcm_pair
    cfg = tp.config
    params = synthetic_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer

    loader.save_diffusers_checkpoint(str(tmp_path), cfg, params, synthetic_tokenizer(1000))
    assert loader.config_from_checkpoint(str(tmp_path)).unet.time_cond_proj_dim == 32
    _, got, _, _ = loader.load_pipeline_checkpoint(str(tmp_path))
    torch.testing.assert_close(got["unet"]["time_embedding.cond_proj.weight"],
                               params["unet"]["time_embedding.cond_proj.weight"])


# -- the hires fix -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["latent", "image"])
def test_generate_hires_matches_jax(pair, mode):
    """64 px → 128 px at strength 0.7: 3 steps, then 2 of 3 on the
    NEAREST-resized map; the image mode with the posterior mean."""
    jp, tp = pair
    kw = dict(KW, num_inference_steps=3, guidance_scale=5.0, upscale_mode=mode,
              hires_strength=0.7, output_type="np", vae_sample_mode="mean")
    want = np.asarray(jp.generate_hires(noise_mode="torch", **kw))
    got = tp.generate_hires(noise_mode="torch", **kw)
    assert got.shape == (1, 128, 128, 3)
    _close_images(got, want)


def test_generate_hires_refusals(pair):
    _, tp = pair
    with pytest.raises(ValueError, match="color_map_image"):
        tp.generate_hires(prompt="a cat")
    with pytest.raises(ValueError, match="generate_hires manages 'strength'"):
        tp.generate_hires(**KW, strength=0.5)
    with pytest.raises(ValueError, match="upscale_mode"):
        tp.generate_hires(**KW, upscale_mode="pixel")
    with pytest.raises(ValueError, match="num_samples=1"):
        tp.generate_hires(**KW, upscale_mode="image", num_samples=2, num_inference_steps=1)


# -- DeepCache on SDXL (ROADMAP A.16c) ---------------------------------------------------

@pytest.fixture(scope="module")
def xl():
    return pipeline_pair(JaxSDModelConfig.tiny_xl(), SDModelConfig.tiny_xl(), seed=33)


def test_tiny_xl_deepcache_matches_jax(xl):
    """DeepCache 2 over 4 steps on the tiny SDXL pipeline (the cached
    feature has ``block_out_channels[1]`` channels), against JAX; then
    ``generate_batch`` with it, row 0 against the request alone, as
    ``tests/test_sdxl.py::test_tiny_xl_generate_batch_and_deepcache`` runs it."""
    jp, tp = xl
    kw = dict(KW, num_inference_steps=4, cache_interval=2, return_latents=True)
    want = np.asarray(jp.generate(noise_mode="torch", **kw))
    got = tp.generate(noise_mode="torch", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())
    assert not np.allclose(got, tp.generate(**dict(kw, cache_interval=1, noise_mode="torch")),
                           atol=1e-4)
    reqs = [dict(KW, seed=1), dict(KW, seed=2, prompt="a fox and a dog")]
    batch = tp.generate_batch(reqs, num_inference_steps=4, cache_interval=2, output_type="np")
    assert batch.shape == (2, 64, 64, 3)
    _close_images(batch[0], tp.generate(**dict(reqs[0], num_inference_steps=4, cache_interval=2,
                                               output_type="np"))[0])


# -- the prompt-editing parser ---------------------------------------------------------------

PARSER_CASES = [  # (text, steps): every string of tests/test_prompt_editing.py
    ("test", 10), ("a [b:.5] c", 10), ("a [b:3]", 10), ("a [b:c:4] d", 10),
    ("a [b::6] c", 10), ("a [[[b]]:2]", 10), ("[(a:2):3]", 10), ("[cat|dog]", 4),
    ("[a|b|c]", 5), ("[x|[y:z:1]]", 4), ("[a:b:2] [c:d:6]", 8), ("a [b] c", 10),
    ("a [b:2] c", 10), ("plain text", 10), ("a [b:2 c", 10), ("[flowers [day:night:0.5]]", 10),
    ("[a [b|c]]", 10), ("a [b (c:1.5)] d", 10), ("[a:b:3]", 8), ("[u:v:5]", 8),
    ("[a:b:4]", 8), ("bad", 8),
]


@pytest.mark.parametrize("text,steps", PARSER_CASES)
def test_prompt_editing_parser_matches_jax(text, steps):
    assert prompt_editing.has_editing(text) == jax_editing.has_editing(text)
    assert (prompt_editing.schedule_prompts(text, steps)
            == jax_editing.schedule_prompts(text, steps))
    for neg in ("", "[u:v:5]", "bad"):
        assert (prompt_editing.combined_schedule(text, neg, steps)
                == jax_editing.combined_schedule(text, neg, steps))


# -- chip_smoke.py's launch tables for the extras -------------------------------------------

def _sd15_visit(hw, batch=2, **kw):
    """K1/K2/K3 wrapper calls of one SD-1.5 UNet call on a hw² latent, traced
    on the meta device (shapes only), by kernel: [(Lq, head dim)]."""
    import chip_smoke
    from pww_tpu_torch.models import unet as tunet
    from pww_tpu_torch.types import PwwState
    from pww_tpu_torch.weights.bridge import build_models

    calls = {n: [] for n in chip_smoke.KernelShapes.NAMES}

    def rec(name, out):
        def fn(q, *a):
            calls[name].append((q.shape[2], q.shape[3]))
            return out(q)
        return fn

    cfg = SDModelConfig.sd15()
    unet = build_models(cfg, parts=("unet",))["unet"]
    with torch.device("meta"), pytest.MonkeyPatch.context() as mp:
        pww = PwwState(weights={(hw >> i) ** 2: torch.empty(batch, (hw >> i) ** 2, 77)
                                for i in range(4)}, weight_orig=None, sigma=torch.empty(()))
        mp.setattr(tunet, "fused_pww_reduce",
                   rec("fused_pww_reduce", lambda q: torch.empty(q.shape[0])))
        mp.setattr(tunet, "fused_pww_cross_attention",
                   rec("fused_pww_cross_attention", torch.empty_like))
        mp.setattr(tunet, "flash_self_attention", rec("flash_self_attention", torch.empty_like))
        if kw.get("cache_mode") == "use":
            kw["cached_feature"] = torch.empty(batch, 640, hw, hw)
        unet(torch.empty(batch, 4, hw, hw), torch.tensor(1.0), torch.empty(batch, 77, 768),
             pww, **kw)
    return calls


def test_extras_launch_tables_match_the_traced_unet():
    """``chip_smoke.py``'s launches per visit: 15/15/10 at 512² (latent
    64²); DeepCache's shallow pass 5/5/5 (down block 0 and the last up
    block, at 64²); SAG's visit, the batched pass and the batch-1 uncond
    pass with the mid block's site dense in f32, 30/30/20; the hires fix's
    1024² visit 16/16/15 (the 16² mid block reaches Lq 256 for K1/K2, the
    32² sites L 1024 for K3)."""
    import chip_smoke

    def per_visit(*calls):
        return tuple(sum(len(c[n]) for c in calls) for n in chip_smoke.KernelShapes.NAMES)

    plain = _sd15_visit(64)
    assert per_visit(plain) == chip_smoke.VISIT
    shallow = _sd15_visit(64, cache_mode="use")
    assert per_visit(shallow) == chip_smoke.SHALLOW_VISIT
    assert {lq for lq, _ in shallow["flash_self_attention"]} == {4096}
    assert per_visit(_sd15_visit(64, sag_probs=[]),
                     _sd15_visit(64, batch=1, sag_probs=[])) == chip_smoke.SAG_VISIT
    hires = _sd15_visit(128)
    assert per_visit(hires) == chip_smoke.HIRES_VISIT
    assert sorted(set(hires["flash_self_attention"])) == [(1024, 160), (4096, 80), (16384, 40)]
    assert chip_smoke.deepcache_launches(30, 5) == (210, 210, 180)
