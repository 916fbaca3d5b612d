"""The port's batched generation: ``generate_batch`` against the JAX
package's in torch noise mode and against the port's own ``generate`` of
each request, per-step callbacks, ``num_samples``, ``output_type="device"``,
the refusals, and the encode caches (CPU, f32)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

STEPS = 3


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=7)


def _req(prompt, seed, shift=0, size=64, **extra):
    """A txt2img request: the test map shifted by ``shift`` columns."""
    return dict(prompt=prompt, color_map_image=np.roll(color_map(size), shift, axis=1),
                seed=seed, color_context={(255, 0, 0): f"{prompt.split()[-1]},1.0",
                                          (0, 0, 255): "dog,0.5,7"}, **extra)


REQS = [_req("a cat", 0), _req("a dog", 1, 16), _req("a fox", 2, 32)]


def _init_image(size=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(xx * 9)], -1) * 200 + rng.normal(0, 12, (size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _mask(size=64, x0=16):
    m = np.zeros((size, size), np.float32)
    m[size // 4: 3 * size // 4, x0: x0 + size // 2] = 1.0
    return m


def _close_images(got, want, share=2e-2):
    """uint8 images within one level on a small share of pixels: f32 sums
    in another order (another batch size, another framework) round across
    a .5 boundary now and then."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


# -- against the JAX package ---------------------------------------------------------

WEIGHT_FUNCTIONS = {  # (JAX, port); None: the default WeightFunction, one batched call
    "batched": (None, None),
    "custom, split CFG": (
        lambda w, sigma, qk: 0.4 * w * jnp.log1p(sigma) * jnp.max(qk),
        lambda w, sigma, qk: 0.4 * w * torch.log1p(sigma) * torch.amax(qk)),
}


@pytest.mark.parametrize("wf", list(WEIGHT_FUNCTIONS))
def test_generate_batch_matches_jax(pair, wf):
    """Three txt2img requests (own prompt, seed, map, a regional seed each)
    against the JAX ``generate_batch(noise_mode="torch")``; rows differ."""
    jp, tp = pair
    jwf, twf = WEIGHT_FUNCTIONS[wf]
    want = np.asarray(jp.generate_batch(REQS, num_inference_steps=STEPS, noise_mode="torch",
                                        weight_function=jwf, output_type="np"))
    got = tp.generate_batch(REQS, num_inference_steps=STEPS, noise_mode="torch",
                            weight_function=twf, output_type="np")
    assert got.shape == (3, 64, 64, 3)
    _close_images(got, want)
    assert not np.array_equal(got[0], got[1]) and not np.array_equal(got[1], got[2])


def test_generate_batch_in_the_default_noise_mode_matches_jax(pair):
    """The three requests with both packages' defaults (``noise_mode=
    "jax"``): each row's latent and regional seeds from its own
    ``PRNGKey(seed)``."""
    jp, tp = pair
    want = np.asarray(jp.generate_batch(REQS, num_inference_steps=STEPS, output_type="np"))
    got = tp.generate_batch(REQS, num_inference_steps=STEPS, output_type="np")
    _close_images(got, want)
    assert not np.array_equal(got, tp.generate_batch(REQS, num_inference_steps=STEPS,
                                                     noise_mode="torch", output_type="np"))


def test_callback_sequence_matches_jax(pair):
    """``callback_steps=2`` over 5 visits: visits 1, 3 and the last, with
    the timestep and the (N, h, w, C) f32 latents the JAX segments pass."""
    jp, tp = pair
    seen = {"jax": [], "torch": []}
    kw = dict(REQS[0], num_inference_steps=5, noise_mode="torch", callback_steps=2)
    jp.generate(callback=lambda i, t, lat: seen["jax"].append((i, t, np.asarray(lat))), **kw)
    tp.generate(callback=lambda i, t, lat: seen["torch"].append((i, t, lat.numpy().copy())),
                **kw)
    assert [s[:2] for s in seen["torch"]] == [s[:2] for s in seen["jax"]]
    assert [s[0] for s in seen["torch"]] == [1, 3, 4]
    for (_, _, got), (_, _, want) in zip(seen["torch"], seen["jax"]):
        assert got.shape == (1, 8, 8, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    final = tp.generate(return_latents=True, **{k: v for k, v in kw.items()
                                                  if k != "callback_steps"})
    np.testing.assert_array_equal(seen["torch"][-1][2], final)


def test_num_samples_matches_jax(pair):
    """``num_samples=2`` in torch noise mode: one (2, C, h, w) draw from the
    seed, both rows against the JAX pipeline's."""
    jp, tp = pair
    kw = dict(REQS[1], num_inference_steps=STEPS, noise_mode="torch", num_samples=2,
              return_latents=True)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


# -- against the port's own generate ---------------------------------------------------

def _rows_match_generate(tp, reqs, **batch_kw):
    got = tp.generate_batch(reqs, num_inference_steps=STEPS, output_type="np", **batch_kw)
    for row, r in zip(got, reqs):
        _close_images(row[None], tp.generate(num_inference_steps=STEPS, output_type="np",
                                             **batch_kw, **r))
    return got


def test_img2img_rows_match_generate(pair):
    """Each request's posterior sample and noise from its own seed."""
    _, tp = pair
    reqs = [_req(p, i, 8 * i, init_image=_init_image(seed=i)) for i, p in
            enumerate(["a cat", "a dog", "a fox"])]
    got = _rows_match_generate(tp, reqs, strength=0.6)
    assert not np.array_equal(got[0], got[1])


def test_legacy_inpaint_rows_match_generate(pair):
    """A 4-channel UNet: the masked blend per row, each request its own
    mask, blur and masked content ("latent_noise" from its own seed)."""
    _, tp = pair
    reqs = [_req("a cat", 3, init_image=_init_image(seed=3), mask_image=_mask(),
                 masked_content="latent_noise"),
            _req("a dog", 4, 16, init_image=_init_image(seed=4), mask_image=_mask(x0=8),
                 mask_blur=2.0),
            _req("a fox", 5, 32, init_image=_init_image(seed=5), mask_image=_mask(x0=24),
                 masked_content="fill")]
    _rows_match_generate(tp, reqs, strength=0.8)


def test_nine_channel_inpaint_rows_match_generate():
    pipe = PwwPipeline(SDModelConfig.tiny(in_channels=9), device="cpu", dtype=torch.float32,
                       seed=2)
    reqs = [_req("a cat", 6, init_image=_init_image(seed=6), mask_image=_mask()),
            _req("a dog", 7, 16, init_image=_init_image(seed=7), mask_image=_mask(x0=8),
                 masked_content="fill")]
    _rows_match_generate(pipe, reqs, strength=1.0)


@pytest.mark.parametrize("config", ["tiny_xl", "tiny_xl_refiner"])
def test_xl_txt2img_rows_match_generate(config):
    """SDXL rows: each request's pooled vector and ``time_ids`` (its own
    size; the refiner's aesthetic scores 6.0 / 2.5)."""
    pipe = PwwPipeline(getattr(SDModelConfig, config)(), device="cpu", dtype=torch.float32,
                       seed=3)
    reqs = [_req("a cat", 8), _req("a dog", 9, 24, negative_prompt="blurry")]
    got = _rows_match_generate(pipe, reqs)
    if config == "tiny_xl":  # the refiner's tiny random VAE decodes both to one image
        assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("refiner", [False, True])
def test_micro_time_ids_layout(refiner):
    """SDXL's 2N time_ids rows, [uncond*N, cond*N], as the JAX pipeline lays
    them out (``pww_tpu/pipeline/pipeline.py:1831-1853, 2444-2474``): per
    request its (original, crop, target) sizes; the refiner's end in the
    aesthetic score, the negative one on the uncond half."""
    from pww_tpu_torch.pipeline.pipeline import micro_time_ids

    got = micro_time_ids(refiner, [(64, 96), (80, 48)], [(0, 0), (4, 8)],
                         [(64, 96), (32, 16)], 6.0, 2.5, "cpu")
    if refiner:
        want = [[64, 96, 0, 0, 2.5], [80, 48, 4, 8, 2.5],
                [64, 96, 0, 0, 6.0], [80, 48, 4, 8, 6.0]]
    else:
        want = [[64, 96, 0, 0, 64, 96], [80, 48, 4, 8, 32, 16]] * 2
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor(want, dtype=torch.float32))


def test_stochastic_step_noise_per_request():
    """An ancestral scheduler draws each row's step noise from its request's
    seed: a row is the request served alone, whatever shares its batch."""
    pipe = PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, seed=4,
                       scheduler="euler_ancestral")
    _rows_match_generate(pipe, REQS[:2])
    other = pipe.generate_batch([REQS[0], REQS[2]], num_inference_steps=STEPS,
                                output_type="np")
    _close_images(other[:1], pipe.generate_batch(REQS[:2], num_inference_steps=STEPS,
                                                 output_type="np")[:1])


def test_output_type_device(pair):
    """The un-fetched uint8 images on the pipeline's device, as np would give."""
    _, tp = pair
    dev = tp.generate_batch(REQS[:2], num_inference_steps=2, output_type="device")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    assert dev.shape == (2, 64, 64, 3) and dev.device == tp.device
    np.testing.assert_array_equal(dev.numpy(), tp.generate_batch(
        REQS[:2], num_inference_steps=2, output_type="np"))
    one = tp.generate(num_inference_steps=2, output_type="device", **REQS[0])
    np.testing.assert_array_equal(one.numpy(), tp.generate(num_inference_steps=2,
                                                           output_type="np", **REQS[0]))


# -- refusals --------------------------------------------------------------------------

def _mixed_grid():
    return [_req("a cat", 0, init_image=_init_image()),
            _req("a dog", 1, size=32, init_image=_init_image())]


BATCH_REFUSALS = {  # requests, generate_batch's options, the error, its message
    "mixed img2img": (lambda: [REQS[0], _req("a dog", 1, init_image=_init_image())], {},
                      ValueError, "img2img"),
    "mixed inpaint": (lambda: [_req("a cat", 0, init_image=_init_image(), mask_image=_mask()),
                               _req("a dog", 1, init_image=_init_image())], {},
                      ValueError, "inpainting"),
    "mask without init": (lambda: [_req("a cat", 0, mask_image=_mask())], {}, ValueError,
                          "init_image"),
    "resolution": (lambda: [REQS[0], _req("a dog", 1, size=128)], {}, ValueError,
                   "resolution"),
    "text length": (lambda: [_req("a cat", 0, long_prompts=True),
                             _req("a " + "word " * 90 + "dog", 1, long_prompts=True)], {},
                    ValueError, "text length"),
    "map grid": (_mixed_grid, {}, ValueError, "color-map grid"),
    "masked content": (lambda: [_req("a cat", 0, init_image=_init_image(), mask_image=_mask(),
                                     masked_content="noise")], {}, ValueError,
                       "masked_content"),
    "mask blur without a mask": (lambda: [_req("a cat", 0, mask_blur=2.0)], {}, ValueError,
                                 "mask_image"),
    # the extras (ROADMAP A.14) as the JAX generate_batch refuses them
    "DeepCache": (lambda: REQS, dict(cache_interval=3, weight_function=lambda w, s, qk: w),
                  ValueError, "batched CFG"),
    "ToMe": (lambda: REQS, dict(tome_ratio="half"), ValueError, "could not convert"),
    "FreeU": (lambda: REQS, dict(freeu=(1.5, 1.6)), ValueError, "freeu must be"),
    "SAG": (lambda: REQS, dict(sag_scale=0.5, weight_function=lambda w, s, qk: w), ValueError,
            "batched CFG"),
    "IP-Adapter": (lambda: REQS, dict(ip_adapter_image=np.zeros((8, 8, 3), np.uint8)),
                   ValueError, "load_ip_adapter"),
    "unknown noise mode": (lambda: REQS, dict(noise_mode="numpy"), ValueError, "noise_mode"),
    "unknown option": (lambda: REQS, dict(sharding="spatial"), NotImplementedError,
                       "sharding"),
}


@pytest.mark.parametrize("case", list(BATCH_REFUSALS))
def test_generate_batch_refusals(pair, case):
    """The JAX ``generate_batch``'s refusals (the extras' since ROADMAP
    A.14); the options the port lacks raise NotImplementedError naming
    their ROADMAP item; a noise mode other than "jax" and "torch" raises
    ValueError; an IP-Adapter image without an adapter attached
    raises ValueError (the JAX one ignores it; tests/test_torch_ip_adapter.py
    runs the batch with one)."""
    _, tp = pair
    reqs, kw, exc, match = BATCH_REFUSALS[case]
    with pytest.raises(exc, match=match):
        tp.generate_batch(reqs(), num_inference_steps=1, **kw)


def test_latent_fill_refused_on_nine_channels():
    pipe = PwwPipeline(SDModelConfig.tiny(in_channels=9), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="legacy"):
        pipe.generate_batch([_req("a cat", 0, init_image=_init_image(), mask_image=_mask(),
                                  masked_content="latent_noise")], num_inference_steps=1)


GENERATE_REFUSALS = {  # generate's options, the error, its message
    "callback with denoising_end": (dict(callback=print, denoising_end=0.5), ValueError,
                                    "callbacks"),
    "callback with DeepCache": (dict(callback=print, cache_interval=2), ValueError,
                                "cache_interval"),
    "callback_steps 0": (dict(callback=print, callback_steps=0), ValueError,
                         "callback_steps"),
    "device output with latents": (dict(output_type="device", return_latents=True),
                                   ValueError, 'output_type="device"'),
    "device output with a callback": (dict(output_type="device", callback=print),
                                      ValueError, 'output_type="device"'),
    "device output with full-res inpaint": (
        dict(output_type="device", inpaint_full_res=True, init_image=_init_image(),
             mask_image=_mask()), ValueError, 'output_type="device"'),
    "prompt editing": (dict(prompt="a [cat:fox:0.5]", prompt_editing=True, cache_interval=2,
                            num_inference_steps=4), ValueError,
                       "prompt_editing is not supported with DeepCache"),
}


@pytest.mark.parametrize("case", list(GENERATE_REFUSALS))
def test_generate_refusals(pair, case):
    _, tp = pair
    kw, exc, match = GENERATE_REFUSALS[case]
    with pytest.raises(exc, match=match):
        tp.generate(**{**REQS[0], "num_inference_steps": 1, **kw})


def test_unported_options_off_are_accepted(pair):
    """A serving request carries every option; off, they change nothing."""
    _, tp = pair
    off = dict(cache_interval=1, tome_ratio=0.0, freeu=None, sag_scale=0.0,
               prompt_editing=False, ip_adapter_image=None)
    kw = dict(REQS[0], num_inference_steps=2, output_type="np")
    np.testing.assert_array_equal(tp.generate(**kw, **off), tp.generate(**kw))


# -- the encode caches -----------------------------------------------------------------

def test_encode_cache_hit_eviction_and_invalidation(pair):
    """An LRU of 32 encodes (a hit refreshes its place, warnings replay on
    every call) and a text cache; ``invalidate_encode_caches`` drops both."""
    _, tp = pair
    tp.invalidate_encode_caches()
    ctx = {(255, 0, 0): "cat,1.0", (0, 255, 0): "absent,1.0"}  # a color not in the map
    with pytest.warns(UserWarning):
        first = tp.encode_inputs("a cat", color_map(64), ctx)
    with pytest.warns(UserWarning):  # the hit replays the encode's warning
        assert tp.encode_inputs("a cat", color_map(64), ctx) is first
    assert len(tp._encode_cache) == 1 and len(tp._text_cache) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(31):
            tp.encode_inputs(f"prompt {i}", None, {})
        tp.encode_inputs("a cat", color_map(64), ctx)  # refreshed: now the newest
        tp.encode_inputs("prompt 31", None, {})  # evicts "prompt 0", the oldest
    keys = [k[0] for k in tp._encode_cache]
    assert len(keys) == 32 and "prompt 0" not in keys and keys[-2:] == ["a cat", "prompt 31"]
    tp.invalidate_encode_caches()
    assert not tp._encode_cache and not tp._text_cache


def test_prewarm_matches_the_per_request_encode(pair):
    """One text-encoder call for a group's uncached pairs (3 padded to 4)
    gives each request the states its own encode would; weighted, long,
    clip-skip requests and a lone pair are left to their own encode."""
    _, tp = pair
    reqs = [_req("a cat", 0), _req("a dog", 1, negative_prompt="blurry"), _req("a fox", 2),
            _req("a cat", 3), _req("a (owl:1.2)", 4, prompt_weighting=True),
            _req("a bee", 5, clip_skip=1)]
    tp.invalidate_encode_caches()
    tp._prewarm_text_cache(reqs)
    assert sorted(k[:2] for k in tp._text_cache) == [("a cat", ""), ("a dog", "blurry"),
                                                     ("a fox", "")]
    warm = dict(tp._text_cache)
    tp.invalidate_encode_caches()
    for key, (states, pooled) in warm.items():
        alone = tp.encode_inputs(key[0], None, {}, key[1]).text_states
        assert pooled is None
        torch.testing.assert_close(states, alone, rtol=1e-5, atol=1e-5)
    tp.invalidate_encode_caches()
    tp._prewarm_text_cache([reqs[0], reqs[3], reqs[4]])  # one plain pair: nothing shared
    assert not tp._text_cache


def test_generate_batch_cold_cache_matches_warm(pair):
    _, tp = pair
    warm = tp.generate_batch(REQS, num_inference_steps=2, output_type="np")
    tp.invalidate_encode_caches()
    cold = tp.generate_batch(REQS, num_inference_steps=2, output_type="np")
    _close_images(cold, warm)
