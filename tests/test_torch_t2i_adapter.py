"""The port's T2I-Adapter against the JAX package's, on bridged tiny weights
(CPU, f32 on both sides).

The features depend on the hint alone: the pipeline computes them once per
call and the UNet adds them in its down blocks (the placement is held by
``tests/test_torch_controlnet.py::
test_unet_with_control_and_adapter_residuals_matches_jax``). Features agree
within f32 summation-order noise (2e-4); final latents of the 3-step
pipelines within 2e-5 of their largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.models.t2i_adapter import T2IAdapter as JaxT2IAdapter
from pww_tpu.models.t2i_adapter import pixel_unshuffle as jax_pixel_unshuffle
from pww_tpu.models.t2i_adapter import t2i_adapter_key
from pww_tpu_torch.models import t2i_adapter as tad
from pww_tpu_torch.weights import safetensors_io
from pww_tpu_torch.weights.bridge import params_from_jax
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

ATOL, RTOL = 2e-4, 2e-4
LAT_TOL = 2e-5
CHANNELS = (32, 64)  # the tiny UNet's blocks


def random_adapter_tree(in_channels: int, seed: int, scale: float = 0.1):
    ad = JaxT2IAdapter(channels=CHANNELS, num_res_blocks=2, downscale_factor=8,
                       in_channels=in_channels)
    shapes = jax.eval_shape(ad.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, in_channels)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * scale,
                        shapes)


def torch_state(tree):
    return params_from_jax({"t2i_adapter": tree})["t2i_adapter"]


def test_pixel_unshuffle_matches_jax():
    """torch's NCHW pixel_unshuffle, channels (c, fh, fw), is what the JAX
    function reproduces on NHWC."""
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jax_pixel_unshuffle(jnp.asarray(x), 8))
    got = tad.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    assert got.shape == (2, 192, 2, 3)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("in_channels", [3, 1])
def test_adapter_features_match_jax(in_channels):
    tree = random_adapter_tree(in_channels, seed=40 + in_channels)
    hint = np.random.default_rng(1).uniform(size=(2, 64, 64, in_channels)).astype(np.float32)
    ad = JaxT2IAdapter(channels=CHANNELS, in_channels=in_channels)
    want = jax.jit(ad.apply)(tree, jnp.asarray(hint))
    net = tad.T2IAdapter(CHANNELS, in_channels=in_channels)
    net.load_state_dict(torch_state(tree), strict=True)
    with torch.inference_mode():
        got = net(torch.from_numpy(hint).permute(0, 3, 1, 2))
    assert [tuple(f.shape) for f in got] == [(2, 32, 8, 8), (2, 64, 4, 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="in_channels"):
        tad.T2IAdapter(CHANNELS, in_channels=4)


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=9)


@pytest.mark.parametrize("layout", ["bare", "adapter.", "file"])
def test_adapter_checkpoints_load_bit_equal_in_both_packages(pair, tmp_path, layout):
    """JAX params under diffusers' keys (the package's ``t2i_adapter_key``),
    bare or under ``adapter.``, as a dict or a ``.safetensors`` file, load
    bit-equal through both pipelines' ``load_t2i_adapter``."""
    jp, tp = pair
    tree = random_adapter_tree(3, seed=50)
    state = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key for p in keypath if p.key != "params")
        key, tf = t2i_adapter_key(path)
        arr = np.transpose(leaf, (3, 2, 0, 1)) if tf == "conv" else leaf
        state[key if layout != "bare" else key[len("adapter."):]] = np.ascontiguousarray(arr)
    source = state
    if layout == "file":
        source = str(tmp_path / "adapter.safetensors")
        safetensors_io.save_file({k: torch.from_numpy(v) for k, v in state.items()}, source)
    jp.load_t2i_adapter(source=source)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                               jax.tree_util.tree_flatten_with_path(jp.t2i_adapter_params)[0]):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(kp))
    tp.load_t2i_adapter(source=source)
    got, want = tp.t2i_adapter.state_dict(), torch_state(tree)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


KW = dict(prompt="a cat and a dog", color_map_image=color_map(64),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5"},
          num_inference_steps=3, seed=0, noise_mode="torch", return_latents=True)


def _hint():
    h = np.zeros((64, 64, 3), np.uint8)
    h[10:50, 10:20] = (255, 200, 40)
    return h


@pytest.mark.parametrize("in_channels", [3, 1])
def test_tiny_adapter_pipeline_matches_jax(pair, in_channels):
    """3 LMS steps with an RGB hint at scale 0.8 against the JAX pipeline in
    torch noise mode; a 1-channel adapter takes the hint's RGB mean. A live
    adapter moves the latents; at scale 0 it adds exact zeros."""
    jp, tp = pair
    tree = random_adapter_tree(in_channels, seed=60 + in_channels, scale=0.3)
    jp.load_t2i_adapter(params=tree, in_channels=in_channels)
    tp.load_t2i_adapter(params=torch_state(tree), in_channels=in_channels)
    kw = dict(KW, adapter_image=_hint(), adapter_conditioning_scale=0.8)
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())
    base = tp.generate(**KW)
    assert not np.allclose(got, base, atol=1e-4)
    np.testing.assert_array_equal(tp.generate(**dict(kw, adapter_conditioning_scale=0.0)), base)


ERROR_CASES = {  # adapter attached, generate's arguments, the error, its message
    "no adapter": (False, dict(adapter_image=_hint()), ValueError, "load_t2i_adapter"),
    "a hint of another size": (True, dict(adapter_image=np.zeros((32, 32, 3), np.uint8)),
                               ValueError, "size"),
    "with DeepCache": (True, dict(adapter_image=_hint(), cache_interval=3), ValueError,
                       "cache_interval > 1 is not supported with a T2I-Adapter"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_adapter_arguments_are_checked(pair, case):
    """The JAX pipeline's refusals (``tests/test_t2i_adapter.py:135-154``)."""
    _, tp = pair
    attached, kw, exc, match = ERROR_CASES[case]
    tp.t2i_adapter = None
    if attached:
        tp.load_t2i_adapter(seed=5)
    with pytest.raises(exc, match=match):
        tp.generate(**dict(KW, num_inference_steps=1), **kw)
