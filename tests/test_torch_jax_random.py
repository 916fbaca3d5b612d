"""The JAX package's random streams in the port: the host threefry
(``pww_tpu_torch.utils.jax_random``) against ``jax.random``, every draw
site against the JAX package's, and the pipelines in their default noise
mode against the JAX pipelines (CPU, f32 on both sides).

Tolerances: bits, keys and integers are equal; f32 normals lie within
1e-6 of jax's (XLA's ``log1p`` is not numpy's; 4.8e-7 seen); bf16 normals
and uniforms are equal. Pipelines: final latents within 2e-5 of their
largest value, the port's other pipeline tests' bound (f32 summation
order over a few UNet calls).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.conditioning import color_context as jcc
from pww_tpu.conditioning import seeding as jseed
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.vae import sample_from_moments as jax_sample_from_moments
from pww_tpu.pipeline.pipeline import _fold_step_rng
from pww_tpu.schedulers.schedules import _step_noise
from pww_tpu.tokenizer import clip_bpe as jtok
from pww_tpu_torch.conditioning import color_context as tcc
from pww_tpu_torch.conditioning import seeding as tseed
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models.vae import sample_from_moments
from pww_tpu_torch.pipeline.facade import paint_with_words
from pww_tpu_torch.pipeline.pipeline import image_keys
from pww_tpu_torch.schedulers.schedules import step_noise
from pww_tpu_torch.tokenizer import clip_bpe as ttok
from pww_tpu_torch.utils import jax_random as jr
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401

LAT_TOL = 2e-5
NORMAL_TOL = 1e-6

# jax 0.9.0 on the CPU, threefry partitionable (chip_smoke.py holds the same)
KNOWN_ANSWERS = {
    "normal": [1.622642159461975, 2.0252647399902344, -0.4335944354534149,
               -0.07861734926700592],
    "bits": [4070199207, 4202968722, 1427181096, 2012915765],
    "split": [[1797259609, 2579123966], [928981903, 3453687069]],
    "fold_in": [2716826189, 292468403],
    "randint": [789, 0, 712, 373],
    "bf16_normal": [0.38671875, 0.1826171875, -1.0, -0.82421875],
}


def test_known_answers_of_prngkey_0():
    k = jr.PRNGKey(0)
    np.testing.assert_allclose(jr.normal(k, (4,)), KNOWN_ANSWERS["normal"], rtol=0,
                               atol=NORMAL_TOL)
    assert jr.bits(k, (4,)).tolist() == KNOWN_ANSWERS["bits"]
    assert jr.split(k).tolist() == KNOWN_ANSWERS["split"]
    assert jr.fold_in(k, 7).tolist() == KNOWN_ANSWERS["fold_in"]
    assert jr.randint(k, (4,), 0, 1000).tolist() == KNOWN_ANSWERS["randint"]
    assert jr.normal(k, (4,), "bfloat16").tolist() == KNOWN_ANSWERS["bf16_normal"]


@pytest.mark.parametrize("seed", [0, 1, 42, -1, -5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5,
                                  2 ** 40 + 3, 7 ^ 0x5EED])
def test_prngkey_matches_jax(seed):
    assert jr.PRNGKey(seed).tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("shape", [(4,), (3, 5, 7), (1, 64, 64, 4), (2, 128, 128, 4)])
def test_bits_match_jax(shape, width):
    k = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.bits(k, shape, getattr(jnp, f"uint{width}")))
    got = jr.bits(np.asarray(k), shape, width)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [2, 5, (2, 3)])
def test_split_matches_jax(num):
    k = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(jr.split(np.asarray(k), num),
                                  np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("data", [0, 1, 17, 2 ** 31 + 5])
def test_fold_in_matches_jax(data):
    k = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(jr.fold_in(np.asarray(k), data),
                                  np.asarray(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4,), (2, 128, 128, 4), (8, 64, 64, 4)])
def test_uniform_and_normal_match_jax(shape, dtype):
    k = jax.random.PRNGKey(7)
    jdt = getattr(jnp, dtype)
    u = np.asarray(jax.random.uniform(k, shape, jdt).astype(jnp.float32))
    np.testing.assert_array_equal(jr.uniform(np.asarray(k), shape, dtype), u)
    want = np.asarray(jax.random.normal(k, shape, jdt).astype(jnp.float32))
    got = jr.normal(np.asarray(k), shape, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)
        assert (got == want).mean() > 0.9  # bit-equal but where XLA's log1p rounds apart


@pytest.mark.parametrize("lo,hi", [(0, 1000), (0, 1), (5, 17), (-3, 2 ** 31 - 1), (0, 3),
                                   (4, 4)])
def test_randint_matches_jax(lo, hi):
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.randint(k, (1000,), lo, hi))
    got = jr.randint(np.asarray(k), (1000,), lo, hi)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_keys_from_jax_pass_as_they_are():
    """A classic ``jax.random.PRNGKey`` goes through ``np.asarray``; a key
    of another shape or type is refused."""
    k = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(jr.normal(k, (3,)), jr.normal(jr.PRNGKey(5), (3,)))
    with pytest.raises(TypeError, match="uint32"):
        jr.normal(np.zeros(2, np.int64), (3,))
    with pytest.raises(TypeError, match="'float32' or 'bfloat16'"):
        jr.normal(k, (3,), "float16")


# -- the draw sites ------------------------------------------------------------------------

def test_make_noise_jax_mode_matches_jax():
    """The NHWC draw permuted to NCHW: an NCHW draw would differ."""
    want = np.asarray(jseed.make_noise(7, (2, 16, 12, 4)))  # JAX default: "jax"
    got = tseed.make_noise(7, (2, 4, 16, 12))  # the port's default: "jax"
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=NORMAL_TOL)
    nchw = jr.normal(jr.PRNGKey(7), (2, 4, 16, 12))
    assert not np.allclose(got.numpy(), nchw)
    with pytest.raises(ValueError, match="noise_mode"):
        tseed.make_noise(7, (1, 4, 8, 8), noise_mode="numpy")


def test_regional_seed_latents_jax_mode_match_jax():
    ctx = {(255, 0, 0): "cat,1.0,3", (0, 0, 255): "dog,0.5,9"}
    cm = color_map(64)
    jreg = jcc.separate_image_context(cm, ctx, jtok.toy_tokenizer(1000))[0]
    treg = tcc.separate_image_context(cm, ctx, ttok.toy_tokenizer(1000))[0]
    base = np.random.default_rng(5).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jseed.regional_seed_latents(jnp.asarray(base), jreg))
    got = tseed.regional_seed_latents(torch.from_numpy(base).permute(0, 3, 1, 2).contiguous(),
                                      treg)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=NORMAL_TOL)
    assert not np.array_equal(want, base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posterior_sample_matches_jax(dtype):
    """``sample_from_moments`` on the key ``image_keys`` gives, in the dtype
    the JAX moments have (the JAX pipeline's compute dtype)."""
    jdt = getattr(jnp, dtype)
    moments = np.random.default_rng(2).standard_normal((1, 8, 8, 8)).astype(np.float32)
    moments = np.array(jnp.asarray(moments, jdt).astype(jnp.float32))
    k_sample, _ = jax.random.split(jax.random.PRNGKey(4))
    want = np.asarray(jax_sample_from_moments(jnp.asarray(moments, jdt), k_sample)
                      .astype(jnp.float32))
    got = sample_from_moments(torch.from_numpy(moments).permute(0, 3, 1, 2), image_keys(4)[0],
                              dtype).permute(0, 2, 3, 1).numpy()
    # f32 draws within 1e-6; the bf16 sample is computed in f32 here (mean +
    # std·ε, each rounded once) and in bf16 there: within one bf16 ulp
    tol = NORMAL_TOL * 4 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_image_keys_follow_rng_or_the_seed():
    np.testing.assert_array_equal(np.stack(image_keys(6)), np.asarray(
        jax.random.split(jax.random.PRNGKey(6))))
    key = jax.random.PRNGKey(123)
    np.testing.assert_array_equal(np.stack(image_keys(6, key)),
                                  np.asarray(jax.random.split(key)))


@pytest.mark.parametrize("per_row", [False, True])
def test_step_noise_matches_jax(per_row):
    """One seed for (2, h, w, c) (``num_samples``), or a key a row
    (``generate_batch``): each row's (h, w, c) draw is the request's own."""
    seeds = [3, 8] if per_row else [3]
    shape = (2, 6, 5, 4)
    keys = jnp.stack([jax.random.PRNGKey(s ^ 0x5EED) for s in seeds])
    rng = keys if per_row else keys[0]
    for i in (0, 4):
        want = np.asarray(_step_noise(_fold_step_rng(rng, i), jnp.zeros(shape), jnp.float32))
        got = step_noise(seeds, i, (2, 4, 6, 5)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)
    if per_row:
        alone = step_noise([8], 4, (1, 4, 6, 5))
        torch.testing.assert_close(step_noise(seeds, 4, (2, 4, 6, 5))[1:], alone,
                                   rtol=0, atol=0)


# -- the pipelines in their default noise mode -----------------------------------------------

KW = dict(prompt="a cat and a dog", color_map_image=color_map(64),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
          num_inference_steps=3, seed=3, return_latents=True)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())


def _init_image(size=64):
    return (np.random.default_rng(0).random((size, size, 3)) * 255).astype(np.uint8)


def _mask(size=64):
    m = np.zeros((size, size), np.float32)
    m[16:48, 16:48] = 1.0
    return m


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=21)


def test_default_txt2img_matches_jax(pair):
    """``generate`` and the facade with default arguments (``noise_mode=
    "jax"``, a regional seed) against the JAX ``generate``'s defaults."""
    jp, tp = pair
    want = np.asarray(jp.generate(**KW))
    _close(tp.generate(**KW), want)
    got = paint_with_words(color_context=KW["color_context"],
                           color_map_image=KW["color_map_image"], input_prompt=KW["prompt"],
                           num_inference_steps=3, seed=3, device="cpu", preloaded_utils=tp,
                           return_latents=True)
    _close(got, want)
    torch_mode = tp.generate(**KW, noise_mode="torch")
    assert not np.allclose(torch_mode, want, atol=1e-2)


IMAGE_CASES = {  # generate's extra arguments
    "img2img, posterior sample": dict(init_image=_init_image(), strength=0.6),
    "img2img, rng=": dict(init_image=_init_image(), strength=0.6, rng="key"),
    "legacy inpaint, latent_noise": dict(init_image=_init_image(), strength=0.8,
                                         mask_image=_mask(), masked_content="latent_noise"),
    "img2img, torch noise": dict(init_image=_init_image(), strength=0.6, noise_mode="torch"),
}


@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_image_draws_match_jax(pair, case):
    """The posterior sample and the "latent_noise" fill from ``split(rng or
    PRNGKey(seed))`` in either noise mode (``vae_sample_mode="sample"``,
    the default)."""
    jp, tp = pair
    kw = dict(KW, **IMAGE_CASES[case])
    if kw.get("rng") == "key":
        kw["rng"] = jax.random.PRNGKey(99)
        no_rng = tp.generate(**dict(kw, rng=None))
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    _close(got, want)
    if "rng" in kw:
        assert not np.allclose(got, no_rng, atol=1e-3)


def _lcm(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, time_cond_proj_dim=32))


@pytest.mark.parametrize("kind", ["euler_ancestral", "dpmpp_2m_sde", "lcm"])
def test_stochastic_schedulers_match_jax_end_to_end(kind):
    """The step noise of ``fold_in(PRNGKey(seed ^ 0x5EED), i)`` at every
    visit: ``generate`` with two samples, and ``generate_batch``'s rows
    (each request's own stream) against the JAX ``generate_batch``."""
    jcfg, tcfg = JaxSDModelConfig.tiny(), SDModelConfig.tiny()
    if kind == "lcm":
        jcfg, tcfg = _lcm(jcfg), _lcm(tcfg)
    jp, tp = pipeline_pair(jcfg, tcfg, seed=22, scheduler=kind)
    kw = dict(KW, num_inference_steps=4, num_samples=2)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    _close(got, want)
    assert not np.allclose(got[0], got[1], atol=1e-3)
    if kind == "euler_ancestral":
        reqs = [dict(prompt="a cat", color_map_image=color_map(64), seed=s,
                     color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "cat,0.5"})
                for s in (1, 5)]
        bw = np.asarray(jp.generate_batch(reqs, num_inference_steps=3, output_type="np"))
        bg = tp.generate_batch(reqs, num_inference_steps=3, output_type="np")
        diff = np.abs(bg.astype(int) - bw.astype(int))
        assert bg.shape == (2, 64, 64, 3) and diff.max() <= 1 and (diff > 0).mean() < 1e-2
