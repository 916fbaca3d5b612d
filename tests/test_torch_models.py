"""The port's CLIP, UNet and VAE decoder against the JAX package's, on
bridged tiny weights (CPU, f32 on both sides).

The UNet runs twice: with the default dispatch thresholds, and with
``flash_min_seq`` lowered to 256 so that at a 16×16 latent (a 128-px image)
both kernel branches are taken — the flash self-attention and the fused
PwW cross-attention pair. In JAX those are the Pallas kernels in interpret
mode; in the port, the wrappers' plain versions (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.conditioning.rasterize import numpy_pyramid
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.models.vae import AutoencoderKL as JaxVAE
from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu.types import PwwState as JPwwState
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models import unet as tunet
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.types import PwwState
from torch_port_cases import pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

# f32 on both sides; differences are summation order through a few dozen
# layers, relative to outputs of order 1-10.
ATOL, RTOL = 2e-4, 2e-4


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=3)


def test_clip_matches_jax(pair):
    jp, tp = pair
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77))
    want = np.asarray(jp.encode_text(jnp.asarray(ids, jnp.int32)))
    got = tp.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL)


def test_vae_decode_matches_jax(pair):
    jp, tp = pair
    z = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(np.float32)
    decode = jax.jit(lambda p, x: jp.vae.apply(p, x, method=JaxVAE.decode))
    want = np.asarray(decode(jp.params["vae"], jnp.asarray(z)))
    got = tp.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want,
                               atol=ATOL, rtol=RTOL)


def _unet_inputs():
    rng = np.random.default_rng(2)
    cm = np.zeros((128, 128), np.float32)
    cm[:, :64] = 1.0
    masks = np.stack([cm * 1.5, 1.0 - cm])
    match = np.zeros((2, 77), np.float32)
    match[0, 2], match[1, 5] = 1.0, 1.0
    pyr, orig = numpy_pyramid(masks, match, 128, 128)
    pair_ = lambda x: np.stack([np.zeros_like(x), x])  # noqa: E731  [uncond, cond]
    weights = {k: pair_(v) for k, v in pyr.items()}
    sample = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    return sample, ctx, weights, pair_(orig)


@pytest.mark.parametrize("flash_min_seq", [1024, 256])
def test_unet_matches_jax(pair, flash_min_seq, monkeypatch):
    jp, tp = pair
    sample, ctx, weights, orig = _unet_inputs()
    t, sigma = 801.0, 4.5

    jcfg = dataclasses.replace(JaxSDModelConfig.tiny().unet, flash_min_seq=flash_min_seq)
    jpww = JPwwState(weights={k: jnp.asarray(v) for k, v in weights.items()},
                     weight_orig=jnp.asarray(orig), sigma=jnp.float32(sigma),
                     weight_fn=JWeightFunction(0.3, "log1p_sigma", "max"))
    unet = JaxUNet(jcfg, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, x, c, w: unet.apply(p, x, jnp.float32(t), c, pww=w))(
        jp.params["unet"], jnp.asarray(sample), jnp.asarray(ctx), jpww))

    tcfg = dataclasses.replace(SDModelConfig.tiny().unet, flash_min_seq=flash_min_seq)
    calls = {"flash": 0, "reduce": 0, "xattn": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tunet, "flash_self_attention", spy("flash", tunet.flash_self_attention))
    monkeypatch.setattr(tunet, "fused_pww_reduce", spy("reduce", tunet.fused_pww_reduce))
    monkeypatch.setattr(tunet, "fused_pww_cross_attention",
                        spy("xattn", tunet.fused_pww_cross_attention))
    for m in tp.unet.modules():
        if isinstance(m, tunet.Attention):
            monkeypatch.setattr(m, "cfg", tcfg)
    tpww = PwwState(weights={k: torch.from_numpy(v) for k, v in weights.items()},
                    weight_orig=torch.from_numpy(orig), sigma=torch.tensor(sigma),
                    weight_fn=WeightFunction(0.3, "log1p_sigma", "max"))
    with torch.inference_mode():
        got = tp.unet(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(t),
                      torch.from_numpy(ctx), tpww)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)
    # three 16×16 sites (down block 0, up block 1 ×2) take the kernel branches;
    # the 8×8 mid block stays dense
    assert calls == {"flash": 3 if flash_min_seq == 256 else 0, "reduce": 3, "xattn": 3}


def test_unet_without_pww_state_is_plain_attention(pair):
    """No PwW state: every cross-attention site is plain attention, and the
    output differs from the biased one."""
    _, tp = pair
    sample, ctx, weights, orig = _unet_inputs()
    args = (torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(500.0),
            torch.from_numpy(ctx))
    tpww = PwwState(weights={k: torch.from_numpy(v) for k, v in weights.items()},
                    weight_orig=torch.from_numpy(orig), sigma=torch.tensor(10.0),
                    weight_fn=WeightFunction(1.0, "log1p_sigma", "max"))
    with torch.inference_mode():
        plain = tp.unet(*args)
        biased = tp.unet(*args, tpww)
    torch.testing.assert_close(plain[0], biased[0])  # uncond row has w = 0
    assert not torch.allclose(plain[1], biased[1], atol=1e-3)
