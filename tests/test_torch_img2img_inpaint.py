"""The port's img2img and inpaint paths against the JAX package's, on bridged
tiny weights (CPU, f32 on both sides).

The JAX side runs ``PwwPipeline.generate`` with ``vae_sample_mode="mean"``
and ``noise_mode="torch"``: the port cannot give ``jax.random``'s bits, so
the sampled modes are held by their invariants instead. Final latents must
agree within f32 summation-order noise, relative to their largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.models.vae import AutoencoderKL as JaxVAE
from pww_tpu.ops.resize import resize_nearest as jax_resize_nearest
from pww_tpu.pipeline import inpaint as jinp
from pww_tpu.pipeline.pipeline import _preprocess_image as jax_preprocess_image
from pww_tpu.pipeline.pipeline import _t_start_from_strength as jax_t_start
from pww_tpu.pipeline.pipeline import run_encode_image
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.ops.resize import resize_linear_antialias, resize_nearest
from pww_tpu_torch.pipeline import inpaint as tinp
from pww_tpu_torch.pipeline.facade import paint_with_words, paint_with_words_inpaint
from pww_tpu_torch.pipeline.pipeline import preprocess_image
from pww_tpu_torch.schedulers.schedules import t_start_from_strength
from pww_tpu_torch.weights.bridge import build_models
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

# f32 on both sides: latents and moments differ by summation order through
# the VAE encoder and a few UNet calls
LAT_TOL = 2e-5
ATOL, RTOL = 2e-4, 2e-4


def _init_image(h=128, w=136, seed=0):
    """A smooth image with texture, wider than a multiple of 32 so that the
    preprocessing resizes it (136 → 128)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 9.0)], -1) * 200.0
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _mask(h=128, w=136):
    m = np.zeros((h, w), np.float32)
    m[24:88, 40:104] = 1.0
    return m


KW = dict(prompt="a cat and a dog", color_map_image=color_map(128),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5"},
          num_inference_steps=4, seed=0, noise_mode="torch", vae_sample_mode="mean",
          return_latents=True)


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=5)


@pytest.fixture(scope="module")
def pair9():
    return pipeline_pair(JaxSDModelConfig.tiny(in_channels=9),
                         SDModelConfig.tiny(in_channels=9), seed=6)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())


# -- host helpers ----------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3, 4, 30, 150])
def test_t_start_from_strength_matches_jax(steps):
    for strength in (0.0, 0.1, 0.33, 0.5, 0.75, 0.99, 1.0):
        for offset in (0, 1):
            assert (t_start_from_strength(steps, strength, offset)
                    == jax_t_start(steps, strength, offset))


def test_preprocess_image_matches_jax():
    img = _init_image(100, 136)
    got = preprocess_image(img)
    assert got.shape == (1, 96, 128, 3)
    np.testing.assert_array_equal(got, np.asarray(jax_preprocess_image(img)))


@pytest.mark.parametrize("out_hw", [(16, 17), (128, 136), (40, 300)])
def test_resizes_match_jax(out_hw):
    """``jax.image.resize(method="linear")`` antialiases when it shrinks (the
    legacy inpaint mask, 128² → 16²); f32 sums in another order."""
    m = _mask()
    want = jax.image.resize(jnp.asarray(m)[None, :, :, None], (1, *out_hw, 1), "linear")
    got = resize_linear_antialias(torch.from_numpy(m), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0, :, :, 0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(m)[None], *out_hw).numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(m)[None], *out_hw)))


@pytest.mark.parametrize("mask_kind", ["array", "pil"])
def test_prepare_mask_and_masked_image_matches_jax(mask_kind):
    from PIL import Image

    img = preprocess_image(_init_image(128, 128))
    m = _mask(128, 128) * 0.7
    mask = Image.fromarray((m * 255).astype(np.uint8)) if mask_kind == "pil" else m
    got = tinp.prepare_mask_and_masked_image(img, mask)
    want = jinp.prepare_mask_and_masked_image(jnp.asarray(img), mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="range"):
        tinp.prepare_mask_and_masked_image(img, m * 2.0)


@pytest.mark.parametrize("sigma", [0.0, 1.5, 6.0])
def test_blur_mask_and_fill_match_jax(sigma):
    m = _mask(64, 64)
    np.testing.assert_array_equal(tinp.blur_mask(m, sigma), jinp.blur_mask(m, sigma))
    if sigma:
        img = preprocess_image(_init_image(64, 64))[0]
        hole = tinp.blur_mask(m, sigma) >= 0.5
        np.testing.assert_array_equal(tinp.fill_masked_region(img, hole),
                                      jinp.fill_masked_region(img, hole))


@pytest.mark.parametrize("box", [(10, 20, 30, 40), (0, 0, 8, 90), (50, 100, 64, 136), None])
def test_crop_region_and_paste_match_jax(box):
    m = np.zeros((64, 136), np.float32)
    if box is not None:
        y0, x0, y1, x1 = box
        m[y0:y1, x0:x1] = 1.0
    for pad in (0, 8, 32):
        region = tinp.expand_crop_region(m, pad, 136, 64)
        assert region == jinp.expand_crop_region(m, pad, 136, 64)
    full = _init_image(64, 136)
    x0, y0, x1, y1 = region
    patch = _init_image(48, 48, seed=1)
    feather = tinp.blur_mask(m, 2.0)
    np.testing.assert_array_equal(tinp.paste_region(full, patch, region, feather),
                                  jinp.paste_region(full, patch, region, feather))


# -- models ----------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_vae_encoder_moments_match_jax(pair, fused):
    """The encoder with its diffusers downsample (asymmetric pad, stride 2)
    and quant_conv; with ``fused_group_norm`` the port runs K4's plain
    version at every site, the JAX package its flax composition on the CPU."""
    jp, tp = pair
    img = preprocess_image(_init_image(64, 64))
    jcfg = dataclasses.replace(jp.config.vae, fused_group_norm=fused)
    want = np.asarray(run_encode_image(JaxVAE(jcfg, dtype=jnp.float32), jp.params["vae"],
                                       jnp.asarray(img)))
    vae = build_models(dataclasses.replace(
        tp.config, vae=dataclasses.replace(tp.config.vae, fused_group_norm=fused)),
        device="cpu")["vae"]
    vae.load_state_dict(tp.vae.state_dict())
    with torch.inference_mode():
        got = vae.encode_moments(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got.shape == (1, 8, 8, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)


def test_unet_with_fused_norms_matches_jax(pair9):
    """The 9-channel tiny UNet with ``fused_group_norm`` and
    ``fused_layer_norm`` on both sides: K4 (norm2 with the time-embedding
    pre-add) and K5 plain versions in the port, flax norms in JAX."""
    jp, tp = pair9
    rng = np.random.default_rng(7)
    sample = rng.standard_normal((2, 16, 16, 9)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    jcfg = dataclasses.replace(jp.config.unet, fused_group_norm=True, fused_layer_norm=True)
    unet = JaxUNet(jcfg, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, x, c: unet.apply(p, x, jnp.float32(601.0), c))(
        jp.params["unet"], jnp.asarray(sample), jnp.asarray(ctx)))
    tcfg = dataclasses.replace(tp.config.unet, fused_group_norm=True, fused_layer_norm=True)
    tunet = build_models(dataclasses.replace(tp.config, unet=tcfg), device="cpu")["unet"]
    tunet.load_state_dict(tp.unet.state_dict())
    with torch.inference_mode():
        got = tunet(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(601.0),
                    torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)


# -- pipeline paths ----------------------------------------------------------------

def test_tiny_img2img_matches_jax(pair):
    """4 steps at strength 0.75: the encode of the init, re-noised at step 1
    (LMS add_noise), and 3 steps from an empty LMS history."""
    jp, tp = pair
    kw = dict(KW, init_image=_init_image(), strength=0.75)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    assert got.shape == (1, 16, 16, 4)
    _close(got, want)
    via_facade = paint_with_words(
        color_context=KW["color_context"], color_map_image=KW["color_map_image"],
        input_prompt=KW["prompt"], num_inference_steps=4, device="cpu", preloaded_utils=tp,
        init_image=_init_image(), strength=0.75, vae_sample_mode="mean", noise_mode="torch",
        return_latents=True)
    np.testing.assert_array_equal(via_facade, got)


@pytest.mark.parametrize("masked_content", ["original", "latent_nothing"])
def test_tiny_legacy_inpaint_with_mask_blur_matches_jax(pair, masked_content):
    """A 4-channel UNet inpaints by the masked blend: the feathered mask
    (mask_blur 4) shrinks to the latent grid through jax.image.resize's
    antialiased linear filter, the unmasked latents follow the init's noise
    trajectory and are restored exactly at the end."""
    jp, tp = pair
    kw = dict(KW, init_image=_init_image(), mask_image=_mask(), strength=1.0, mask_blur=4.0,
              masked_content=masked_content)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    _close(got, want)


@pytest.mark.parametrize("masked_content", ["original", "fill"])
def test_tiny_9ch_inpaint_matches_jax(pair9, masked_content):
    """A 9-channel UNet takes [latents, mask, masked-image latents]; at
    strength 1.0 the init is still noised at step 0, as the reference does."""
    jp, tp = pair9
    kw = dict(KW, init_image=_init_image(), mask_image=_mask(), strength=1.0,
              masked_content=masked_content)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    _close(got, want)


def test_inpaint_full_res_paste_back_matches_jax(pair9):
    """Crop around the blurred mask, inpaint the crop at full size, paste it
    back blended by the mask: outside the crop the init survives bit for
    bit; inside, the uint8 images agree within one level on a small share of
    pixels (rounding at .5 boundaries of outputs that match in f32)."""
    jp, tp = pair9
    init = _init_image(128, 128)
    kw = dict(KW, init_image=init, mask_image=_mask(128, 128)[:, ::-1].copy(), strength=1.0,
              mask_blur=3.0, inpaint_full_res=True, inpaint_full_res_padding=8,
              output_type="np", return_latents=False)
    jp.profile = True  # the JAX pipeline's unfused denoise-then-decode path
    try:
        want = np.asarray(jp.generate(**kw))
    finally:
        jp.profile = False
    got = tp.generate(**kw)
    assert got.shape == want.shape == (1, 128, 128, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    m = tinp.blur_mask(_mask(128, 128)[:, ::-1], 3.0)
    x0, y0, x1, y1 = tinp.expand_crop_region((m > 1e-3).astype(np.float32), 8, 128, 128)
    outside = np.ones((128, 128), bool)
    outside[y0:y1, x0:x1] = False
    assert outside.any() and (got[0][outside] == init[outside]).all()


def test_custom_weight_function_split_cfg_matches_jax(pair):
    """A lambda weight function takes the two-call CFG, the uncond call with
    no bias at all (``pww_tpu/pipeline/pipeline.py:114-151``)."""
    jp, tp = pair
    kw = dict(KW, num_inference_steps=2)
    want = np.asarray(jp.generate(
        weight_function=lambda w, sigma, qk: 0.4 * w * jnp.log1p(sigma) * jnp.max(qk), **kw))
    got = tp.generate(
        weight_function=lambda w, sigma, qk: 0.4 * w * torch.log1p(sigma) * torch.amax(qk),
        **kw)
    _close(got, want)
    batched = tp.generate(**kw)  # the default WeightFunction, one batched call
    assert not np.allclose(got, batched)


# -- the port alone ------------------------------------------------------------------

def test_sampled_modes_are_seeded_and_keep_the_unmasked_latents(pair):
    """The sampled modes draw torch numbers, not jax.random's: the same seed
    gives the same result, another seed another; the legacy blend leaves
    the unmasked latents at the init's posterior mean whatever fills the hole."""
    _, tp = pair
    kw = dict(KW, init_image=_init_image(), strength=0.75)
    sample = dict(kw, vae_sample_mode="sample")
    a, b = tp.generate(**sample), tp.generate(**sample)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, tp.generate(**dict(sample, seed=1)))
    assert not np.allclose(a, tp.generate(**kw))

    lat = tp.generate(**dict(kw, mask_image=_mask(), strength=1.0,
                             masked_content="latent_noise"))
    init = tp.encode_image(preprocess_image(_init_image()))[:, :4] * 0.18215
    m = resize_linear_antialias(torch.from_numpy(_mask(128, 128)), 16, 16).numpy()
    keep = m == 0
    assert keep.any() and (m >= 0.5).any()
    np.testing.assert_allclose(lat[0][keep], init[0].permute(1, 2, 0).numpy()[keep],
                               rtol=0, atol=1e-6)


def test_inpaint_facade_resizes_map_and_mask_to_the_init(pair9):
    """``paint_with_words_inpaint`` resizes the color map and the mask to the
    init image's size (nearest), as the reference does."""
    from PIL import Image

    _, tp = pair9
    init = _init_image(128, 128)
    small_map, small_mask = color_map(64), (_mask(64, 64) * 255).astype(np.uint8)
    args = dict(color_context=KW["color_context"], input_prompt=KW["prompt"],
                num_inference_steps=2, device="cpu", preloaded_utils=tp,
                vae_sample_mode="mean", return_latents=True)
    got = paint_with_words_inpaint(color_map_image=small_map, init_image=init,
                                   mask_image=small_mask, **args)
    want = paint_with_words_inpaint(
        color_map_image=np.asarray(Image.fromarray(small_map).resize((128, 128), Image.NEAREST)),
        init_image=init,
        mask_image=np.asarray(Image.fromarray(small_mask).resize((128, 128), Image.NEAREST)),
        **args)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="9-channel"):
        tp.generate(**dict(KW, init_image=init, mask_image=_mask(128, 128),
                           masked_content="latent_noise"))
