"""The port's host prologue against the JAX package's: tokenizer, color
context, bias pyramid, PwW state, resize/blur and noise (CPU, f32)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.conditioning import color_context as jcc
from pww_tpu.conditioning import rasterize as jras
from pww_tpu.conditioning import seeding as jseed
from pww_tpu.ops import blur as jblur
from pww_tpu.ops import resize as jresize
from pww_tpu.tokenizer import clip_bpe as jtok
from pww_tpu.types import PwwState as JPwwState
from pww_tpu_torch.conditioning import color_context as tcc
from pww_tpu_torch.conditioning import rasterize as tras
from pww_tpu_torch.conditioning import seeding as tseed
from pww_tpu_torch.ops import blur as tblur
from pww_tpu_torch.ops import resize as tresize
from pww_tpu_torch.tokenizer import clip_bpe as ttok
from pww_tpu_torch.types import PwwState
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

PROMPTS = ["a cat sitting next to a dog, realistic photo", "", "aurora, 4k!!",
           "A cat and a dog and another cat"]


@pytest.mark.parametrize("make", ["toy_tokenizer", "synthetic_tokenizer"])
def test_tokenizer_ids_match_jax(make):
    size = 1000 if make == "toy_tokenizer" else 49408
    jt, tt = getattr(jtok, make)(size), getattr(ttok, make)(size)
    for p in PROMPTS:
        kw = dict(max_length=77, truncation=True, padding="max_length")
        assert tt(p, **kw)["input_ids"] == jt(p, **kw)["input_ids"]


def _cm(h=64, w=96):
    cm = np.zeros((h, w, 3), np.uint8)
    cm[:, : w // 2] = (255, 0, 0)
    cm[: h // 4, w // 2 :] = (0, 0, 255)
    return cm


CONTEXT = {(255, 0, 0): "cat,1.5", "#0000ff": "dog,0.5,7,2.0",
           (0, 255, 0): "grass@0.3@11"}


def _parse(mod, tok, prompt="a cat and a dog on grass"):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        regions, w, h = mod.separate_image_context(_cm(), CONTEXT, tok)
        ids = tok(prompt, max_length=77, truncation=True,
                  padding="max_length")["input_ids"]
        match = mod.token_match_matrix(regions, ids, 77)
    return regions, (w, h), match, sorted(str(r.message) for r in rec)


def test_color_context_and_token_match_match_jax_including_warnings():
    jr, jwh, jm, jw = _parse(jcc, jtok.toy_tokenizer(1000))
    tr, twh, tm, tw = _parse(tcc, ttok.toy_tokenizer(1000))
    assert twh == jwh == (96, 64)
    np.testing.assert_array_equal(tm, jm)
    for a, b in zip(tr, jr):
        assert (a.color, a.label, a.strength, a.token_ids, a.seed, a.blur_sigma) == (
            b.color, b.label, b.strength, b.token_ids, b.seed, b.blur_sigma)
        np.testing.assert_array_equal(a.mask, b.mask)
    # green is absent from the map: both warn the same way
    assert tw == jw and any("not found in the color map" in m for m in tw)


def test_label_missing_from_prompt_warns_like_jax():
    jw = _parse(jcc, jtok.toy_tokenizer(1000), prompt="a horse")[3]
    tw = _parse(tcc, ttok.toy_tokenizer(1000), prompt="a horse")[3]
    assert tw == jw and any("not found in prompt" in m for m in tw)


def test_empty_context_gives_the_sentinel_region():
    regions, w, h = tcc.separate_image_context(None, {}, ttok.toy_tokenizer(1000))
    assert (w, h) == (512, 512) and regions[0].token_ids == [-1]
    assert regions[0].mask.shape == (512, 512) and not regions[0].mask.any()


@pytest.mark.parametrize("hw", [(64, 96), (100, 60), (512, 512)])
@pytest.mark.parametrize("blur", [False, True])
def test_rasterize_pyramid_matches_numpy_pyramid(hw, blur):
    """Level sizes from always_round, coarser levels winning key collisions,
    bilinear align_corners=True: bit-close to the JAX package's pyramid."""
    h, w = hw
    rng = np.random.default_rng(0)
    masks = (rng.random((3, h, w)) > 0.5).astype(np.float32) * [[[1.0]], [[0.5]], [[2.0]]]
    masks = masks.astype(np.float32)
    match = rng.integers(0, 3, (3, 77)).astype(np.float32)
    sig = np.array([0.0, 1.5, 3.0], np.float32) if blur else None
    jp, jo = jras.numpy_pyramid(masks, match, h, w, blur_sigmas=sig)
    tp, to = tras.rasterize_pyramid(torch.from_numpy(masks), torch.from_numpy(match),
                                    sig, height=h, width=w)
    assert sorted(tp) == sorted(jp)
    tol = 1e-4 if blur else 1e-5  # blur: conv vs gather-dot summation order
    for key in jp:
        np.testing.assert_allclose(tp[key].numpy(), jp[key], rtol=tol, atol=tol)
    np.testing.assert_allclose(to.numpy(), jo, rtol=tol, atol=tol)


@pytest.mark.parametrize("q_len", [4096, 96, 600])
def test_pww_state_bias_for_matches_jax(q_len):
    """Sizes in the pyramid are looked up; others take the ORIG fallback
    (floored bilinear size, then 1-D nearest)."""
    rng = np.random.default_rng(1)
    pyr = {4096: rng.random((2, 4096, 77)).astype(np.float32)}
    orig = rng.random((2, 80, 96, 77)).astype(np.float32)
    js = JPwwState(weights={k: jnp.asarray(v) for k, v in pyr.items()},
                   weight_orig=jnp.asarray(orig), sigma=jnp.float32(1.0))
    ts = PwwState(weights={k: torch.from_numpy(v) for k, v in pyr.items()},
                  weight_orig=torch.from_numpy(orig), sigma=torch.tensor(1.0))
    got = ts.bias_for(q_len)
    assert got.shape == (2, q_len, 77) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(js.bias_for(q_len)),
                               rtol=1e-6, atol=1e-6)
    assert PwwState({}, None, torch.tensor(0.0)).bias_for(q_len) is None


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("out_hw", [(8, 12), (1, 5), (40, 33)])
def test_resize_bilinear_matches_jax(align, out_hw):
    x = np.random.default_rng(2).random((2, 3, 20, 17)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out_hw, align_corners=align))
    got = tresize.resize_bilinear(torch.from_numpy(x), *out_hw, align_corners=align)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_len", [7, 64, 100])
def test_resize_nearest_1d_matches_jax(out_len):
    x = np.random.default_rng(3).random((2, 4, 48)).astype(np.float32)
    want = np.asarray(jresize.resize_nearest_1d(jnp.asarray(x), out_len))
    np.testing.assert_array_equal(
        tresize.resize_nearest_1d(torch.from_numpy(x), out_len).numpy(), want)


@pytest.mark.parametrize("sigma", [0.8, 2.0, 6.0])
def test_gaussian_blur_matches_jax(sigma):
    x = np.random.default_rng(4).random((2, 48, 40)).astype(np.float32)
    want = np.asarray(jblur.gaussian_blur(jnp.asarray(x), 39, sigma))
    got = tblur.gaussian_blur(torch.from_numpy(x), 39, sigma)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_make_noise_torch_mode_is_bit_identical():
    """The reference's draw, asked for by name (the default is the JAX
    package's "jax", tests/test_torch_jax_random.py); an unknown mode raises."""
    want = np.asarray(jseed.make_noise(7, (2, 16, 12, 4), "torch"))  # NHWC
    got = tseed.make_noise(7, (2, 4, 16, 12), "torch")  # NCHW
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    with pytest.raises(ValueError, match="noise_mode"):
        tseed.make_noise(7, (1, 4, 8, 8), noise_mode="numpy")


def test_regional_seed_latents_match_jax():
    ctx = {(255, 0, 0): "cat,1.0,3", (0, 0, 255): "dog,0.5,9"}
    jr = jcc.separate_image_context(_cm(), ctx, jtok.toy_tokenizer(1000))[0]
    tr = tcc.separate_image_context(_cm(), ctx, ttok.toy_tokenizer(1000))[0]
    base = np.random.default_rng(5).standard_normal((1, 8, 12, 4)).astype(np.float32)
    want = np.asarray(jseed.regional_seed_latents(jnp.asarray(base), jr, "torch"))
    got = tseed.regional_seed_latents(
        torch.from_numpy(base).permute(0, 3, 1, 2).contiguous(), tr, "torch")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(want, base)  # the seeds did replace the foreground
