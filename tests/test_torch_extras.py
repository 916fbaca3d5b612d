"""The sampling extras in the port against the JAX package (CPU, f32 on
both sides): ToMe's token merge, FreeU's filter, the UNet with ToMe, FreeU,
SAG's probabilities and DeepCache's collect and use passes, and the tiny
pipeline with DeepCache, SAG and prompt editing; ``generate_batch`` with
each extra, row against request.

Both tiny configs lower ``tome_min_tokens`` to 64, so that the 8×8 sites of
a 64-px image (and the 16×16 and 8×8 ones of a 128-px UNet input) merge.

Tolerances: the token merge's indices must be equal and its outputs within
1e-6 (f32 scatter-means in another order); one UNet call within 1e-5 of
its largest output (as ``tests/test_torch_sdxl.py``); pipelines on the
final latents within 2e-5 of the largest (f32 summation order over a few
UNet calls).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.conditioning.rasterize import numpy_pyramid
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.models.unet import fourier_filter as jax_fourier_filter
from pww_tpu.ops.tome import build_token_merge as jax_token_merge
from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu.types import PwwState as JPwwState
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models.unet import fourier_filter
from pww_tpu_torch.ops.tome import build_token_merge
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.pipeline.pipeline import sag_mask
from pww_tpu_torch.types import PwwState
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401

UNET_TOL = 1e-5
LAT_TOL = 2e-5
KW = dict(prompt="a cat and a dog", color_map_image=color_map(64),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
          num_inference_steps=3, seed=0, guidance_scale=5.0, return_latents=True)


def _lowered(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, tome_min_tokens=64))


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(_lowered(JaxSDModelConfig.tiny()), _lowered(SDModelConfig.tiny()),
                         seed=21)


def _close(got, want, tol=LAT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# -- ToMe ------------------------------------------------------------------------------

def _metric(kind, h, w, rng):
    if kind == "random":
        return rng.standard_normal((2, h * w, 16)).astype(np.float32)
    if kind == "constant":  # every similarity ties (tests/test_tome.py:51)
        return np.broadcast_to(rng.standard_normal((1, 1, 16)), (2, h * w, 16)).astype(np.float32)
    # one-hot tokens: exact similarities (0 or 1/(1+1e-6)²) in both
    # packages, so that the order of the many ties is the sort's alone
    return np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, h * w))]


TOME_CASES = {  # (metric, h, w, ratio, the merged length)
    "random 8x8, 0.5": ("random", 8, 8, 0.5, 32),
    "constant 8x8, 0.5": ("constant", 8, 8, 0.5, 32),
    "random 4x4, 0.9: bounded by the src tokens": ("random", 4, 4, 0.9, 4),
    "one-hot 32x32, 0.3: aligned to 256": ("one-hot", 32, 32, 0.3, 768),
    "one-hot 64x64, 0.5: aligned to 1024": ("one-hot", 64, 64, 0.5, 2048),
    "one-hot 64x64, 0.3: aligned up to 3072": ("one-hot", 64, 64, 0.3, 3072),
}


@pytest.mark.parametrize("case", list(TOME_CASES))
def test_token_merge_matches_jax(case):
    """The merge indices (read through ``unmerge`` of the slot numbers,
    which gives each token the merged slot it takes) are equal, and merge
    and unmerge of random features agree within 1e-6."""
    kind, h, w, ratio, l_m = TOME_CASES[case]
    rng = np.random.default_rng(3)
    metric = _metric(kind, h, w, rng)
    slots = np.broadcast_to(np.arange(l_m, dtype=np.float32)[None, :, None], (2, l_m, 1))
    y = rng.standard_normal((2, h * w, 8)).astype(np.float32)
    z = rng.standard_normal((2, l_m, 8)).astype(np.float32)

    @jax.jit
    def jax_side(metric, slots, y, z):
        merge, unmerge, _ = jax_token_merge(metric, h, w, ratio)
        return unmerge(slots), merge(y), unmerge(z)

    assert jax_token_merge(jnp.asarray(metric), h, w, ratio)[2] == l_m
    want = [np.asarray(a) for a in jax_side(*map(jnp.asarray, (metric, slots, y, z)))]
    tm, tu, tl = build_token_merge(torch.from_numpy(metric), h, w, ratio)
    assert tl == l_m
    np.testing.assert_array_equal(tu(torch.from_numpy(slots.copy())).numpy(), want[0])
    np.testing.assert_allclose(tm(torch.from_numpy(y)).numpy(), want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu(torch.from_numpy(z)).numpy(), want[2], rtol=0, atol=1e-6)


def test_fourier_filter_matches_jax():
    """NCHW in the port, NHWC in JAX; odd and even grids."""
    rng = np.random.default_rng(4)
    for h, w in ((8, 8), (7, 10)):
        x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
        want = np.asarray(jax_fourier_filter(jnp.asarray(x), 1, 0.2))
        got = fourier_filter(torch.from_numpy(x).permute(0, 3, 1, 2), 1, 0.2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


# -- the UNet ----------------------------------------------------------------------------

def _unet_inputs():
    """A 128-px call: 16×16 latents, the PwW pyramid of a two-region map."""
    rng = np.random.default_rng(5)
    cm = np.zeros((128, 128), np.float32)
    cm[:, :64] = 1.0
    match = np.zeros((2, 77), np.float32)
    match[0, 2], match[1, 5] = 1.0, 1.0
    pyr, orig = numpy_pyramid(np.stack([cm * 1.5, 1.0 - cm]), match, 128, 128)
    pair_ = lambda x: np.stack([np.zeros_like(x), x])  # noqa: E731  [uncond, cond]
    return (rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
            rng.standard_normal((2, 77, 32)).astype(np.float32),
            {k: pair_(v) for k, v in pyr.items()}, pair_(orig))


UNET_CASES = {  # JAX config fields, the port's forward arguments, JAX's
    "ToMe 0.5": (dict(tome_ratio=0.5), dict(tome_ratio=0.5), {}),
    "FreeU": (dict(freeu=(1.5, 1.6, 0.9, 0.2)), dict(freeu=(1.5, 1.6, 0.9, 0.2)), {}),
    "SAG probabilities": (dict(sow_mid_attn=True), dict(sag_probs=[]), {}),
    "DeepCache collect": ({}, dict(cache_mode="collect"), dict(cache_mode="collect")),
    "DeepCache use": ({}, dict(cache_mode="use"), dict(cache_mode="use")),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_extras_match_jax(pair, case):
    """One UNet call with each extra. DeepCache's use pass takes a random
    cached feature of up block 0's output shape (64 channels at 16×16);
    its skips come from down block 0 alone, without the downsampler."""
    jp, tp = pair
    jcfg_kw, tkw, jkw = UNET_CASES[case]
    sample, ctx, weights, orig = _unet_inputs()
    t, sigma = 601.0, 3.5
    feature = np.random.default_rng(6).standard_normal((2, 16, 16, 64)).astype(np.float32)
    if case == "DeepCache use":
        jkw = dict(jkw, cached_feature=jnp.asarray(feature))
        tkw = dict(tkw, cached_feature=torch.from_numpy(feature).permute(0, 3, 1, 2))
    unet = JaxUNet(dataclasses.replace(jp.config.unet, **jcfg_kw), dtype=jnp.float32)
    jpww = JPwwState(weights={k: jnp.asarray(v) for k, v in weights.items()},
                     weight_orig=jnp.asarray(orig), sigma=jnp.float32(sigma),
                     weight_fn=JWeightFunction(0.3, "log1p_sigma", "max"))
    feat = jkw.pop("cached_feature", None)
    want, interm = jax.jit(lambda p, x, c, w, f: unet.apply(
        p, x, jnp.float32(t), c, pww=w, mutable=["intermediates"], cached_feature=f, **jkw))(
        jp.params["unet"], jnp.asarray(sample), jnp.asarray(ctx), jpww, feat)
    tpww = PwwState(weights={k: torch.from_numpy(v) for k, v in weights.items()},
                    weight_orig=torch.from_numpy(orig), sigma=torch.tensor(sigma),
                    weight_fn=WeightFunction(0.3, "log1p_sigma", "max"))
    with torch.inference_mode():
        got = tp.unet(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(t),
                      torch.from_numpy(ctx), tpww, **tkw)
    if case == "DeepCache collect":
        (got, got_f), (want, want_f) = got, want
        assert tuple(got_f.shape) == (2, 64, 16, 16)
        _close(got_f.permute(0, 2, 3, 1).numpy(), want_f, UNET_TOL)
    _close(got.permute(0, 2, 3, 1).numpy(), want, UNET_TOL)
    plain = tp.unet(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(t),
                    torch.from_numpy(ctx), tpww)
    if case == "DeepCache collect":  # the full pass, with its feature
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    elif case != "SAG probabilities":  # SAG's f32 site is the same function in f32
        assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-4)
    else:
        want_p = np.asarray(jax.tree_util.tree_leaves(interm)[0])
        got_p = tkw["sag_probs"][0].numpy()
        assert got_p.shape == want_p.shape == (2, 4, 64, 64)  # the 8×8 mid block
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(sag_mask(torch.from_numpy(got_p)).numpy(),
                                      np.asarray(want_p).mean(1).sum(1) > 1.0)


# -- the pipeline ------------------------------------------------------------------------

PIPELINE_CASES = {  # generate's options on both sides
    "DeepCache 3": dict(cache_interval=3, num_inference_steps=5),
    "ToMe 0.5": dict(tome_ratio=0.5),
    "FreeU": dict(freeu=True),
    "SAG 0.75": dict(sag_scale=0.75),
    "prompt editing": dict(prompt="a [cat:fox:0.5] and a dog", prompt_editing=True,
                           num_inference_steps=4),
    "prompt editing, alternation and negative": dict(
        prompt="a [cat|fox] and a dog", negative_prompt="[blurry::2]", prompt_editing=True,
        num_inference_steps=4),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_pipeline_extras_match_jax(pair, case):
    """The tiny pipeline with each extra against the JAX one in torch noise
    mode, on the final latents; each extra changes them."""
    jp, tp = pair
    kw = dict(KW, **PIPELINE_CASES[case])
    want = np.asarray(jp.generate(noise_mode="torch", **kw))
    got = tp.generate(noise_mode="torch", **kw)
    _close(got, want)
    off = {k: v for k, v in kw.items()
           if k not in ("cache_interval", "tome_ratio", "freeu", "sag_scale", "prompt_editing")}
    assert not np.allclose(got, tp.generate(noise_mode="torch", **off), atol=1e-4)


def test_sag_masks_match_jax_bit_for_bit(pair):
    """SAG's masks at every visit of a 4-step LMS run, from the port's own
    loop latents through both UNets (the JAX one sows its probabilities):
    equal bit for bit. The keys within 1e-5 of the cut at 1.0 are counted
    and printed, not avoided."""
    jp, tp = pair
    seen = []
    unet = JaxUNet(dataclasses.replace(jp.config.unet, sow_mid_attn=True), dtype=jnp.float32)
    real = tp.unet.forward

    def spy(*args, sag_probs=None, **kw):
        out = real(*args, sag_probs=sag_probs, **kw)
        if sag_probs is not None and args[0].shape[0] == 2:  # the batched pass
            seen.append((args, sag_probs[0]))
        return out

    tp.unet.forward = spy
    try:
        tp.generate(**dict(KW, sag_scale=0.75, num_inference_steps=4))
    finally:
        del tp.unet.forward
    assert len(seen) == 4
    near = 0
    probs_of = jax.jit(lambda p, x, t, c, w: jax.tree_util.tree_leaves(
        unet.apply(p, x, t, c, pww=w, mutable=["intermediates"])[1])[0])
    for (lat2, t, ctx, pww, *_), probs in seen:
        jpww = JPwwState(weights={k: jnp.asarray(v.numpy()) for k, v in pww.weights.items()},
                         weight_orig=jnp.asarray(pww.weight_orig.numpy()),
                         sigma=jnp.float32(pww.sigma), weight_fn=JWeightFunction())
        want = np.asarray(probs_of(jp.params["unet"],
                                   jnp.asarray(lat2.permute(0, 2, 3, 1).numpy()),
                                   jnp.float32(t), jnp.asarray(ctx.numpy()), jpww))[:1]
        got = probs[:1]
        received = got.mean(1).sum(1).numpy()
        near += int((np.abs(received - 1.0) < 1e-5).sum())
        np.testing.assert_array_equal(sag_mask(got).numpy(), want.mean(1).sum(1) > 1.0)
    print(f"SAG: {near} of {4 * 16} uncond keys within 1e-5 of the cut")


def test_deepcache_visits_full_every_interval(pair):
    """``cache_interval=3`` over 7 visits from ``t_start`` 0: full visits
    0, 3 and 6, shallow ones between, each shallow one on the feature of
    the last full visit."""
    _, tp = pair
    modes, last = [], {}
    real = tp.unet.forward

    def spy(*args, cache_mode=None, cached_feature=None, **kw):
        out = real(*args, cache_mode=cache_mode, cached_feature=cached_feature, **kw)
        modes.append(cache_mode)
        if cache_mode == "collect":
            last["feature"] = out[1]
        else:
            assert cached_feature is last["feature"]
        return out

    tp.unet.forward = spy
    try:
        tp.generate(**dict(KW, cache_interval=3, num_inference_steps=7))
    finally:
        del tp.unet.forward
    assert modes == ["collect", "use", "use"] * 2 + ["collect"]


# -- generate_batch, row against request -----------------------------------------------

def _req(prompt, seed, shift=0):
    return dict(prompt=prompt, color_map_image=np.roll(color_map(64), shift, axis=1), seed=seed,
                color_context={(255, 0, 0): f"{prompt.split()[-1]},1.0",
                               (0, 0, 255): "dog,0.5,7"})


BATCH_OPTIONS = {
    "DeepCache 2": dict(cache_interval=2),
    "ToMe 0.5": dict(tome_ratio=0.5),
    "FreeU": dict(freeu=(1.2, 1.3, 0.8, 0.4)),
    "SAG 0.5": dict(sag_scale=0.5),
}


@pytest.mark.parametrize("case", list(BATCH_OPTIONS))
def test_generate_batch_extras_rows_match_generate(pair, case):
    """Two requests through ``generate_batch`` with an extra: each row is
    its request through ``generate`` alone with the same extra (uint8
    images within one level on 2% of the pixels, f32 sums over another
    batch size), and the extra changes the rows."""
    _, tp = pair
    opts = BATCH_OPTIONS[case]
    reqs = [_req("a cat", 0), _req("a fox", 1, 16)]
    got = tp.generate_batch(reqs, num_inference_steps=3, output_type="np", **opts)
    for row, r in zip(got, reqs):
        alone = tp.generate(**r, num_inference_steps=3, output_type="np", **opts)[0]
        diff = np.abs(row.astype(int) - alone.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 2e-2
    plain = tp.generate_batch(reqs, num_inference_steps=3, output_type="np")
    assert not np.array_equal(got, plain)


# -- refusals ------------------------------------------------------------------------------

REFUSALS = {  # generate's options, the error, its message (the JAX pipeline's)
    "SAG, custom weight function": (dict(sag_scale=0.5, weight_function=lambda w, s, qk: w),
                                    ValueError, "custom weight"),
    "SAG, callback": (dict(sag_scale=0.5, callback=lambda *a: None), ValueError, "callback"),
    "SAG, DeepCache": (dict(sag_scale=0.5, cache_interval=3), ValueError, "DeepCache"),
    "SAG, legacy inpaint": (dict(sag_scale=0.5, init_image=np.zeros((64, 64, 3), np.uint8),
                                 mask_image=np.ones((64, 64), np.float32)),
                            ValueError, "legacy masked-blend"),
    "DeepCache, custom weight function": (dict(cache_interval=2,
                                               weight_function=lambda w, s, qk: w),
                                          ValueError, "batched CFG"),
    "DeepCache, legacy inpaint": (dict(cache_interval=2,
                                       init_image=np.zeros((64, 64, 3), np.uint8),
                                       mask_image=np.ones((64, 64), np.float32)),
                                  ValueError, "legacy masked-blend"),
    "prompt editing, SAG": (dict(prompt="a [cat:fox:0.5]", prompt_editing=True, sag_scale=0.5),
                            ValueError, "prompt_editing is not supported with sag_scale"),
    "prompt editing, denoising_end": (dict(prompt="a [cat:fox:0.5]", prompt_editing=True,
                                           denoising_end=0.5, return_latents=True),
                                      ValueError, "denoising_end"),
    "FreeU, a bad tuple": (dict(freeu=(1.0, 1.0)), ValueError, "freeu must be"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_extras_refusals_match_jax(pair, case):
    """Each combination the JAX pipeline refuses: the same exception type
    and subject in both packages."""
    jp, tp = pair
    kw, exc, match = REFUSALS[case]
    args = dict(KW, num_inference_steps=2, return_latents=False, output_type="np")
    args.update(kw)
    with pytest.raises(exc, match=match):
        tp.generate(**args)
    if "weight_function" in kw:  # JAX's custom functions take jnp arrays
        args["weight_function"] = lambda w, s, qk: w
    with pytest.raises(exc, match=match):
        jp.generate(noise_mode="torch", **args)
