"""The port's legacy masked-blend inpainting, A1111 mask_blur / masked-content
modes and inpaint_full_res, and its inpaint-prep host ops: the tests of
tests/test_legacy_inpaint.py and tests/test_inpaint_numerics.py, each run on
the port and held against the JAX package on the same tiny weights (CPU,
f32, the JAX package's own noise on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.pipeline import inpaint as jinp
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.ops.resize import resize_linear_antialias
from pww_tpu_torch.pipeline import inpaint as tinp
from torch_port_cases import few_torch_threads, pipeline_pair  # noqa: F401 (autouse)

# f32 on both sides: final latents within summation-order noise relative to
# their largest value (tests/test_torch_pipeline.py:74), images within one
# level (rounding at .5)
LAT_TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair()


@pytest.fixture(scope="module")
def pair9():
    return pipeline_pair(JaxSDModelConfig.tiny(in_channels=9), SDModelConfig.tiny(in_channels=9))


def _mask(size=64):
    m = np.zeros((size, size), np.float32)
    m[16:48, 16:48] = 1.0
    return m


def _init(size=64):
    rng = np.random.default_rng(0)
    return (rng.random((size, size, 3)) * 255).astype(np.uint8)


def _kw(**kw):
    base = dict(prompt="a cat", num_inference_steps=3, strength=0.8, output_type="np")
    base.update(kw)
    return base


def both(pair, **kw):
    """(port result, JAX result) of one generate call; images within one
    level, latents within LAT_TOL."""
    jp, tp = pair
    jkw = dict(kw)
    if "jax_weight_function" in kw:  # the callable in each package's ops
        jkw["weight_function"] = jkw.pop("jax_weight_function")
        del kw["jax_weight_function"]
    got, want = np.asarray(tp.generate(**kw)), np.asarray(jp.generate(**jkw))
    assert got.shape == want.shape
    if got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())
    return got, want


def test_legacy_inpaint_runs_on_4ch_checkpoint(pair):
    out, _ = both(pair, init_image=_init(), mask_image=_mask(), seed=0, **_kw())
    assert out.shape[-3:] == (64, 64, 3)
    assert np.isfinite(out.astype(np.float64)).all()


def test_legacy_inpaint_unmasked_latents_pinned_to_init(pair):
    """The final restore makes unmasked latents exactly the init image's:
    with a shared VAE-sample key, two seeds agree bit for bit outside the
    mask and differ inside it, on the port as on the JAX package."""
    m = _mask()
    kw = _kw(init_image=_init(), mask_image=m, rng=jax.random.PRNGKey(42), return_latents=True)
    kw.pop("output_type")
    la, _ = both(pair, seed=0, **kw)
    lb, _ = both(pair, seed=1, **kw)
    m_lat = resize_linear_antialias(torch.from_numpy(m), 8, 8).numpy()[None, :, :, None]
    keep = np.broadcast_to(m_lat == 0.0, la.shape)
    repaint = np.broadcast_to(m_lat == 1.0, la.shape)
    np.testing.assert_array_equal(la[keep], lb[keep])
    assert not np.array_equal(la[repaint], lb[repaint])


def test_mask_blur_feathers_the_seam(pair):
    hard, _ = both(pair, init_image=_init(), mask_image=_mask(), seed=3, **_kw())
    soft, _ = both(pair, init_image=_init(), mask_image=_mask(), seed=3, mask_blur=4.0, **_kw())
    assert soft.shape == hard.shape
    assert np.isfinite(soft.astype(np.float64)).all()
    assert not np.array_equal(hard, soft)


def test_masked_content_modes_differ(pair):
    common = dict(init_image=_init(), mask_image=_mask(), seed=5)
    outs = {mode: both(pair, masked_content=mode, **common, **_kw())[0]
            for mode in ("original", "fill", "latent_noise", "latent_nothing")}
    for mode, img in outs.items():
        assert np.isfinite(img.astype(np.float64)).all(), mode
    assert not np.array_equal(outs["original"], outs["latent_noise"])
    assert not np.array_equal(outs["original"], outs["latent_nothing"])
    assert not np.array_equal(outs["original"], outs["fill"])


def test_masked_content_fill_works_on_9ch_checkpoint(pair9):
    out, _ = both(pair9, init_image=_init(), mask_image=_mask(), seed=0, masked_content="fill",
                  mask_blur=2.0, **_kw(num_inference_steps=2, strength=1.0))
    assert np.isfinite(out.astype(np.float64)).all()
    # latent_* modes are a latent-blend concept: 9-channel conditioning rejects
    for pipe in pair9:
        with pytest.raises(ValueError, match="legacy"):
            pipe.generate(init_image=_init(), mask_image=_mask(),
                          masked_content="latent_noise", **_kw())


def test_legacy_inpaint_with_callback_and_custom_wf(pair):
    steps = {"port": [], "jax": []}
    out, _ = both(
        pair, init_image=_init(), mask_image=_mask(), seed=2,
        callback=lambda i, t, lat: steps["port" if isinstance(lat, torch.Tensor)
                                         else "jax"].append(i),
        weight_function=lambda w, s, qk: w * torch.log1p(s) * torch.max(qk),
        jax_weight_function=lambda w, s, qk: w * jnp.log1p(s) * jnp.max(qk),
        color_map_image=np.full((64, 64, 3), [255, 0, 0], np.uint8),
        color_context={(255, 0, 0): "cat,1.0"}, **_kw())
    assert len(steps["port"]) >= 1 and steps["port"] == steps["jax"]
    assert np.isfinite(out.astype(np.float64)).all()


def test_mask_kwargs_validation(pair):
    for pipe in pair:
        with pytest.raises(ValueError, match="masked_content"):
            pipe.generate(init_image=_init(), mask_image=_mask(), masked_content="bogus",
                          **_kw())
        with pytest.raises(ValueError, match="mask_image"):
            pipe.generate(mask_blur=3.0, **_kw())
        with pytest.raises(ValueError, match="mask_image"):
            pipe.generate(masked_content="fill", **_kw())


# -- inpaint_full_res (A1111 "inpaint area: only masked") --------------------


def test_expand_crop_region_geometry():
    m = np.zeros((100, 200), np.float32)
    m[40:60, 90:110] = 1.0  # 20x20 box centered-ish
    x0, y0, x1, y1 = tinp.expand_crop_region(m, 10, 200, 100)
    assert (x0, y0, x1, y1) == tuple(jinp.expand_crop_region(m, 10, 200, 100))
    # contains the padded bbox
    assert x0 <= 80 and x1 >= 120 and y0 <= 30 and y1 >= 70
    # aspect matches the 2:1 processing aspect
    assert abs((x1 - x0) / (y1 - y0) - 2.0) < 0.15
    assert 0 <= x0 < x1 <= 200 and 0 <= y0 < y1 <= 100

    # border clamp: mask in a corner still yields an in-bounds region
    m2 = np.zeros((100, 200), np.float32)
    m2[0:10, 0:10] = 1.0
    x0, y0, x1, y1 = tinp.expand_crop_region(m2, 30, 200, 100)
    assert (x0, y0, x1, y1) == tuple(jinp.expand_crop_region(m2, 30, 200, 100))
    assert x0 == 0 and y0 == 0 and x1 <= 200 and y1 <= 100
    assert x1 >= 40 and y1 >= 40

    # empty mask: whole image
    assert tinp.expand_crop_region(np.zeros((50, 60)), 8, 60, 50) == (0, 0, 60, 50)


def test_paste_region_blend_and_resize():
    full = np.zeros((64, 64, 3), np.uint8)
    patch = np.full((16, 16, 3), 200, np.uint8)  # will upscale to 32x32
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    mask[16:48, 16] = 0.5  # feathered column
    out = tinp.paste_region(full, patch, (16, 16, 48, 48), mask)
    np.testing.assert_array_equal(out, jinp.paste_region(full, patch, (16, 16, 48, 48), mask))
    assert out[0, 0].tolist() == [0, 0, 0]  # outside region untouched
    assert out[32, 32].tolist() == [200, 200, 200]  # inside fully pasted
    assert out[32, 16, 0] == 100  # fractional mask blends
    assert full[32, 32, 0] == 0  # input not mutated


def test_inpaint_full_res_pastes_outside_exactly(pair):
    """Pixels where the mask is 0 are byte-identical to the init image (the
    paste blends only masked pixels), and masked pixels change."""
    init, m = _init(), _mask()
    out, _ = both(pair, init_image=init, mask_image=m, seed=0, inpaint_full_res=True,
                  inpaint_full_res_padding=8, **_kw())
    outside = m == 0.0
    np.testing.assert_array_equal(out[0][outside], init[outside])
    assert not np.array_equal(out[0][~outside], init[~outside])


def test_inpaint_full_res_with_blur_and_color_map(pair):
    cm = np.zeros((64, 64, 3), np.uint8)
    cm[:, :32] = (255, 0, 0)
    init = _init()
    out, _ = both(pair, init_image=init, mask_image=_mask(), seed=1, inpaint_full_res=True,
                  mask_blur=3.0, color_map_image=cm, color_context={(255, 0, 0): "cat,1.0"},
                  **_kw())
    assert out[0].shape == (64, 64, 3)
    # far corners (outside mask+blur reach) still exact
    np.testing.assert_array_equal(out[0][:4, :4], init[:4, :4])


def test_inpaint_full_res_validation(pair):
    for pipe in pair:
        with pytest.raises(ValueError, match="inpaint_full_res"):
            pipe.generate(inpaint_full_res=True, **_kw())
        with pytest.raises(ValueError, match="return_latents"):
            pipe.generate(init_image=_init(), mask_image=_mask(), inpaint_full_res=True,
                          return_latents=True, **_kw())


def test_legacy_inpaint_rejects_denoising_end(pair):
    """The final exact restore assumes a complete trajectory: both packages
    refuse an ensemble split with the legacy blend."""
    for pipe in pair:
        with pytest.raises(ValueError, match="denoising_end"):
            pipe.generate(init_image=_init(), mask_image=_mask(), seed=0, denoising_end=0.5,
                          return_latents=True, **_kw())


# -- the inpaint-prep host ops (tests/test_inpaint_numerics.py) -------------------


def _gauss2d_rederived(arr: np.ndarray, sigma: float) -> np.ndarray:
    """The documented definition, re-derived: a truncated normalized
    gaussian at radius max(int(3σ), 1), per-axis convolution with edge
    replication, with np.pad + np.convolve."""
    radius = max(int(3 * sigma), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    m = np.asarray(arr, np.float32)
    mp = np.pad(m, ((radius, radius), (0, 0)), mode="edge")
    m = np.stack([np.convolve(mp[:, j], k, mode="valid") for j in range(m.shape[1])], axis=1)
    mp = np.pad(m, ((0, 0), (radius, radius)), mode="edge")
    m = np.stack([np.convolve(mp[i, :], k, mode="valid") for i in range(m.shape[0])], axis=0)
    return m.astype(np.float32)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 4.0, 16.0])
def test_gauss2d_matches_rederivation(sigma):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((40, 56)).astype(np.float32)  # signed values
    got = tinp._gauss2d(arr, sigma)
    np.testing.assert_allclose(got, _gauss2d_rederived(arr, sigma), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, jinp._gauss2d(arr, sigma), rtol=0, atol=1e-6)


def test_gauss2d_preserves_mean_of_constant():
    arr = np.full((17, 23), 0.37, np.float32)
    np.testing.assert_allclose(tinp._gauss2d(arr, 8.0), arr, atol=1e-6)
    np.testing.assert_allclose(tinp._gauss2d(arr, 8.0), jinp._gauss2d(arr, 8.0), atol=1e-7)


def test_blur_mask_identity_at_zero_and_range():
    m = np.zeros((32, 32), np.float32)
    m[8:24, 8:24] = 1.0
    np.testing.assert_array_equal(tinp.blur_mask(m, 0.0), m)
    b = tinp.blur_mask(m, 5.0)
    np.testing.assert_allclose(b, jinp.blur_mask(m, 5.0), atol=1e-6)
    assert b.min() >= 0.0 and b.max() <= 1.0
    assert 0.0 < b[7, 16] < 1.0  # feather extends past the hard edge


def test_fill_known_pixels_unchanged_and_bounded():
    rng = np.random.default_rng(1)
    img = rng.random((48, 48, 3)).astype(np.float32) * 2 - 1
    hole = np.zeros((48, 48), bool)
    hole[12:36, 12:36] = True
    out = tinp.fill_masked_region(img, hole)
    np.testing.assert_allclose(out, jinp.fill_masked_region(img, hole), atol=1e-6)
    np.testing.assert_array_equal(out[~hole], img[~hole])  # context untouched
    known = img[~hole]  # filled values are diffused-in context: in its range
    assert out[hole].min() >= known.min() - 1e-5
    assert out[hole].max() <= known.max() + 1e-5
    assert np.isfinite(out).all()


def test_fill_constant_image_is_fixpoint():
    img = np.full((32, 32, 3), -0.25, np.float32)
    hole = np.zeros((32, 32), bool)
    hole[8:24, 4:28] = True
    out = tinp.fill_masked_region(img, hole)
    np.testing.assert_allclose(out, img, atol=1e-4)
    np.testing.assert_allclose(out, jinp.fill_masked_region(img, hole), atol=1e-6)


def test_fill_fully_masked_falls_back_to_mean():
    rng = np.random.default_rng(2)
    img = rng.random((16, 16, 3)).astype(np.float32) * 2 - 1
    out = tinp.fill_masked_region(img, np.ones((16, 16), bool))
    np.testing.assert_allclose(out, np.broadcast_to(img.mean(axis=(0, 1)), out.shape),
                               atol=1e-5)
    np.testing.assert_allclose(out, jinp.fill_masked_region(img, np.ones((16, 16), bool)),
                               atol=1e-6)


def test_blurred_mask_support_grows_crop_region():
    """The inpaint_full_res seam: the crop comes from the blurred mask's
    support, so a feather wider than the padding lands inside the pasted
    region."""
    m = np.zeros((256, 256), np.float32)
    m[120:136, 120:136] = 1.0
    mb = tinp.blur_mask(m, 24.0)
    pad = 8
    x0, y0, x1, y1 = tinp.expand_crop_region((mb > 1e-3).astype(np.float32), pad, 256, 256)
    assert (x0, y0, x1, y1) == tuple(jinp.expand_crop_region(
        (jinp.blur_mask(m, 24.0) > 1e-3).astype(np.float32), pad, 256, 256))
    ys, xs = np.nonzero(mb > 1e-3)
    assert y0 <= ys.min() and ys.max() < y1
    assert x0 <= xs.min() and xs.max() < x1
    hx0, hy0, hx1, hy1 = tinp.expand_crop_region(m, pad, 256, 256)
    assert (x1 - x0) > (hx1 - hx0) and (y1 - y0) > (hy1 - hy0)
