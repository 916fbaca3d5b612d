"""The port's ControlNet (single and stacked) against the JAX package's, on
bridged tiny weights (CPU, f32 on both sides).

A freshly initialised ControlNet adds nothing (its zero convs are zero), so
every comparison here runs on random weights in every tensor, zero convs
included. The hint is RGB in [0, 1], NHWC in JAX and NCHW in the port.
Modules agree within f32 summation-order noise (2e-4); final latents of
the 3-step pipelines within 2e-5 of their largest value, as the port's
other pipeline tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from pww_tpu.conditioning.rasterize import numpy_pyramid
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.controlnet import ControlNet as JaxControlNet
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu.types import PwwState as JPwwState
from pww_tpu.weights import loader as jax_loader
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models import unet as tunet
from pww_tpu_torch.models.controlnet import ZERO_CONV_PREFIXES, ControlNetModel
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.types import PwwState
from pww_tpu_torch.weights import loader
from pww_tpu_torch.weights.bridge import params_from_jax
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

ATOL, RTOL = 2e-4, 2e-4  # modules: f32 in another summation order
LAT_TOL = 2e-5  # final latents, relative to their largest value


def random_controlnet_tree(cfg, seed: int, scale: float = 0.1):
    """numpy tree shaped like the JAX ControlNet's ``init`` for ``cfg``; norm
    scales 1 + scale·N(0, 1), every other leaf (zero convs too) scale·N(0, 1)."""
    cn = JaxControlNet(cfg.unet)
    side = 2 ** (len(cfg.unet.block_out_channels) - 1)
    sf = cfg.vae.scale_factor
    shapes = jax.eval_shape(
        cn.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, cfg.unet.in_channels)),
        jnp.zeros((1,)), jnp.zeros((1, 77, cfg.unet.cross_attention_dim)),
        jnp.zeros((1, side * sf, side * sf, 3)), added_cond=jax_loader.init_added_cond(cfg))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32) * scale
        return 1.0 + x if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _state(tree):
    """The port's state dict for a JAX ControlNet tree."""
    return params_from_jax({"controlnet": tree})["controlnet"]


def torch_controlnet(cfg, tree) -> ControlNetModel:
    net = ControlNetModel(cfg.unet)
    net.load_state_dict(_state(tree), strict=True)
    return net.eval().requires_grad_(False)


def hints(size: int = 64):
    h1 = np.zeros((size, size, 3), np.uint8)
    h1[size // 4: size * 5 // 8, size // 4: size * 5 // 8] = 255
    h2 = np.zeros((size, size, 3), np.uint8)
    h2[size // 12: size // 4, size // 12: size - 4] = (255, 128, 0)
    return h1, h2


def _pww_inputs(size: int = 128):
    """A two-region bias pyramid at ``size`` px, rows [uncond, cond]."""
    cm = np.zeros((size, size), np.float32)
    cm[:, : size // 2] = 1.0
    masks = np.stack([cm * 1.5, 1.0 - cm])
    match = np.zeros((2, 77), np.float32)
    match[0, 2], match[1, 5] = 1.0, 1.0
    pyr, orig = numpy_pyramid(masks, match, size, size)
    pair_ = lambda x: np.stack([np.zeros_like(x), x])  # noqa: E731
    weights = {k: pair_(v) for k, v in pyr.items()}
    wf = ("log1p_sigma", "max")
    jpww = JPwwState(weights={k: jnp.asarray(v) for k, v in weights.items()},
                     weight_orig=jnp.asarray(pair_(orig)), sigma=jnp.float32(4.5),
                     weight_fn=JWeightFunction(0.3, *wf))
    tpww = PwwState(weights={k: torch.from_numpy(v) for k, v in weights.items()},
                    weight_orig=torch.from_numpy(pair_(orig)), sigma=torch.tensor(4.5),
                    weight_fn=WeightFunction(0.3, *wf))
    return jpww, tpww


def _dh40(cfg):
    """A UNet of 80 and 160 channels at head dim 40, every 16×16 site on a
    kernel branch."""
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, block_out_channels=(80, 160), attention_head_dim=40, flash_min_seq=256))


# -- modules ------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [8, 40])
def test_controlnet_matches_jax(head_dim, monkeypatch):
    """Residuals and their count (the conv_in skip, one per layer, one per
    downsampler) at scale 0.7. At head dim 40 the 16×16 site takes K3 and
    K1 + K2 (their plain versions on the CPU, the Pallas kernels in
    interpret mode in JAX); at head dim 8 every site is dense."""
    jcfg, tcfg = JaxSDModelConfig.tiny(), SDModelConfig.tiny()
    if head_dim == 40:
        jcfg, tcfg = _dh40(jcfg), _dh40(tcfg)
    tree = random_controlnet_tree(jcfg, seed=11)
    rng = np.random.default_rng(12)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    hint = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    jpww, tpww = _pww_inputs()
    cn = JaxControlNet(jcfg.unet)
    want_down, want_mid = jax.jit(
        lambda p, x, c, h, w: cn.apply(p, x, jnp.float32(801.0), c, h, pww=w,
                                       conditioning_scale=0.7))(
        tree, jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(hint), jpww)

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
    net = torch_controlnet(tcfg, tree)
    with torch.inference_mode():
        down, mid = net(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.tensor(801.0),
                        torch.from_numpy(ctx), torch.from_numpy(hint).permute(0, 3, 1, 2),
                        tpww, 0.7)
    n_blocks = len(tcfg.unet.block_out_channels)
    assert len(down) == len(want_down) == 1 + n_blocks * tcfg.unet.layers_per_block + n_blocks - 1
    for got, want in zip(down + (mid,), tuple(want_down) + (want_mid,)):
        assert float(np.abs(want).max()) > 0.1  # live residuals, not zero convs
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    want_calls = 1 if head_dim == 40 else 0
    assert calls == {"flash": want_calls, "reduce": want_calls, "xattn": want_calls}
    # an SD net ignores SDXL's added_cond, as the JAX one does
    with torch.inference_mode():
        again, _ = net(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.tensor(801.0),
                       torch.from_numpy(ctx), torch.from_numpy(hint).permute(0, 3, 1, 2),
                       tpww, 0.7, added_cond={"time_ids": None})
    assert all(torch.equal(a, b) for a, b in zip(again, down))


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=7)


def test_unet_with_control_and_adapter_residuals_matches_jax(pair):
    """Down-block residuals on every skip (the conv_in skip included), the
    mid residual after the mid block, and T2I-Adapter features: block 0
    (attention) after its transformer, inside its skip; block 1 (no
    attention) after the block, outside every skip."""
    jp, tp = pair
    rng = np.random.default_rng(13)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sample, ctx = r(2, 16, 16, 4), r(2, 77, 32)
    down = [r(2, 16, 16, 32), r(2, 16, 16, 32), r(2, 8, 8, 32), r(2, 8, 8, 64)]
    mid = r(2, 8, 8, 64)
    intra = [r(2, 16, 16, 32), r(2, 8, 8, 64)]
    unet = JaxUNet(jp.config.unet, dtype=jnp.float32)
    jpww, tpww = _pww_inputs()
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)  # noqa: E731
    apply = jax.jit(lambda p, x, c, w, d, m, i: unet.apply(
        p, x, jnp.float32(801.0), c, pww=w, down_block_residuals=d, mid_block_residual=m,
        down_intrablock_residuals=i))

    def port(down=None, mid=None, intra=None):
        with torch.inference_mode():
            return tp.unet(nchw(sample), torch.tensor(801.0), torch.from_numpy(ctx), tpww,
                           None if down is None else [nchw(x) for x in down],
                           None if mid is None else nchw(mid),
                           None if intra is None else [nchw(x) for x in intra])

    def both(down=None, mid=None, intra=None):
        want = apply(jp.params["unet"], sample, ctx, jpww, down, mid, intra)
        got = port(down, mid, intra)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        return got

    plain = port()
    full = both(down, mid, intra)
    # the attention-less block's feature alone still moves the output
    last = both(intra=[np.zeros_like(intra[0]), intra[1]])
    assert not torch.allclose(plain, full, atol=1e-3) and not torch.allclose(plain, last,
                                                                           atol=1e-3)


# -- weights ------------------------------------------------------------------------

def _inverse(tf):
    """The JAX loader's transform, undone: flax layout → torch layout."""
    if tf is jax_loader.t_conv:
        return lambda a: np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
    if tf is jax_loader.t_dense:
        return lambda a: np.ascontiguousarray(a.T)
    return lambda a: a


def test_controlnet_checkpoints_load_bit_equal_in_both_packages(tmp_path):
    """JAX params written under diffusers' keys (the JAX loader's own
    ``controlnet_key``, 1×1 ``conv_out``) load bit-equal through both
    loaders. The port's writer stores diffusers' 3×3 ``conv_out``: the
    port's loader reads that directory back bit-equal, and the JAX loader
    refuses it (ROADMAP C.8)."""
    jcfg, tcfg = JaxSDModelConfig.tiny(), SDModelConfig.tiny()
    tree = random_controlnet_tree(jcfg, seed=21)
    state = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key for p in keypath if p.key != "params")
        key, tf = jax_loader.controlnet_key(path, leaf.ndim)
        state[key] = _inverse(tf)(leaf)
    file = str(tmp_path / "controlnet.safetensors")
    safetensors.numpy.save_file(state, file)

    back = jax_loader.load_controlnet_checkpoint(file, jcfg)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                               jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(kp))
    want = _state(tree)
    got = loader.load_controlnet_checkpoint(file, tcfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    d = str(tmp_path / "cn_dir")
    loader.save_controlnet_checkpoint(d, tcfg, want, weights_format="bin")
    again = loader.load_controlnet_checkpoint(d, tcfg)
    assert all(torch.equal(again[k], want[k]) for k in want)
    assert again["controlnet_cond_embedding.conv_out.weight"].shape[2:] == (3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_loader.load_controlnet_checkpoint(d, jcfg)


# -- pipelines ----------------------------------------------------------------------

KW = dict(prompt="a cat and a dog", color_map_image=color_map(64),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5"},
          num_inference_steps=3, seed=0, noise_mode="torch", return_latents=True)


@pytest.fixture(scope="module")
def nets():
    """Two ControlNet trees for the tiny config."""
    cfg = JaxSDModelConfig.tiny()
    return random_controlnet_tree(cfg, seed=31), random_controlnet_tree(cfg, seed=32, scale=0.15)


def _attach_port(tp, trees):
    tp.load_controlnet(params=_state(trees[0]))
    for tree in trees[1:]:
        tp.add_controlnet(params=_state(tree))


def _attach(jp, tp, trees):
    jp.load_controlnet(params=trees[0])
    for tree in trees[1:]:
        jp.add_controlnet(params=tree)
    _attach_port(tp, trees)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())


def _jax_lambda(w, sigma, qk):
    return 0.4 * w * jnp.log1p(sigma) * jnp.max(qk)


def _torch_lambda(w, sigma, qk):
    return 0.4 * w * torch.log1p(sigma) * torch.amax(qk)


def _init_image(size: int = 64):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return (np.stack([xx, yy, 0.5 + 0.5 * np.sin(xx * 9.0)], -1) * 220.0).astype(np.uint8)


# (nets attached, generate's extra arguments for JAX and for the port)
PIPELINE_CASES = {
    "single": (1, dict(control_image=hints()[0], controlnet_conditioning_scale=0.7), {}),
    "multi": (2, dict(control_image=list(hints()), controlnet_conditioning_scale=[0.7, 0.9]), {}),
    "split": (1, dict(control_image=hints()[0], controlnet_conditioning_scale=0.7),
              dict(jax=dict(weight_function=_jax_lambda),
                   torch=dict(weight_function=_torch_lambda))),
    "img2img": (1, dict(control_image=hints()[1], init_image=_init_image(), strength=0.7,
                        vae_sample_mode="mean"), {}),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_tiny_controlnet_pipeline_matches_jax(pair, nets, case):
    """3 LMS steps with one ControlNet at scale 0.7, two at [0.7, 0.9], one
    with a custom weight function (the split path: the ControlNet runs per
    CFG half, the uncond one without bias), and img2img with a control
    image; each against the JAX pipeline in torch noise mode, and unlike
    the run without control."""
    jp, tp = pair
    k, kw, sides = PIPELINE_CASES[case]
    _attach(jp, tp, nets[:k])
    want = np.asarray(jp.generate(**KW, **kw, **sides.get("jax", {})))
    got = tp.generate(**KW, **kw, **sides.get("torch", {}))
    _close(got, want)
    plain = {key: v for key, v in kw.items()
             if key not in ("control_image", "controlnet_conditioning_scale")}
    assert not np.allclose(got, tp.generate(**KW, **plain, **sides.get("torch", {})),
                           atol=1e-4)


def test_second_net_at_scale_zero_reproduces_the_single_net(pair, nets):
    """A stacked net at scale 0 adds exact zeros: the latents of one net,
    bit for bit; a shared hint goes to every net."""
    _, tp = pair
    h1, h2 = hints()
    _attach_port(tp, nets[:1])
    single = tp.generate(**KW, control_image=h1, controlnet_conditioning_scale=0.7)
    tp.add_controlnet(params=_state(nets[1]))
    both = tp.generate(**KW, control_image=[h1, h2], controlnet_conditioning_scale=[0.7, 0.0])
    np.testing.assert_array_equal(single, both)
    shared = tp.generate(**KW, control_image=h1, controlnet_conditioning_scale=[0.7, 0.9])
    assert np.isfinite(shared).all() and not np.allclose(shared, single)


def test_fresh_controlnet_adds_nothing(pair):
    """load_controlnet() with no weights keeps the zero convs zero, as a
    fresh JAX ControlNet does: the latents equal the run without control."""
    _, tp = pair
    tp.load_controlnet(seed=3)
    state = tp.controlnets[0].state_dict()
    assert all(not v.any() for k, v in state.items() if k.startswith(ZERO_CONV_PREFIXES))
    assert all(v.any() for k, v in state.items() if not k.startswith(ZERO_CONV_PREFIXES))
    np.testing.assert_array_equal(tp.generate(**KW, control_image=hints()[0]),
                                  tp.generate(**KW))


def test_residual_scale_is_rounded_to_the_compute_dtype(nets):
    """In bf16 the residuals are bf16(r)·bf16(0.7), as the reference's
    ``jnp.asarray(scale, dtype)`` (``pww_tpu/models/controlnet.py:179-183``);
    the f32 scale 0.7 would round some of them the other way."""
    cfg = SDModelConfig.tiny()
    net = torch_controlnet(cfg, nets[0]).to(torch.bfloat16)
    rng = np.random.default_rng(14)
    args = (torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32)),
            torch.tensor(500.0),
            torch.from_numpy(rng.standard_normal((1, 77, 32)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(1, 3, 64, 64)).astype(np.float32)))
    with torch.inference_mode():
        one, _ = net(*args, conditioning_scale=1.0)
        scaled, _ = net(*args, conditioning_scale=0.7)
    s16 = torch.tensor(0.7, dtype=torch.bfloat16).float()
    for a, b in zip(scaled, one):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, (b.float() * s16).to(torch.bfloat16))
    f32 = [(b.float() * 0.7).to(torch.bfloat16) for b in one]
    assert any(not torch.equal(a, b) for a, b in zip(scaled, f32))


def test_controlnet_on_a_9_channel_unet_raises_as_the_reference_cannot_run_it(nets):
    """pww_tpu builds the ControlNet's conv_in for the UNet's 9 input
    channels but feeds it the 4-channel latents: flax refuses the kernel's
    shape. The port raises a ValueError naming ROADMAP C.7."""
    from flax.errors import ScopeParamShapeError

    jcfg, tcfg = JaxSDModelConfig.tiny(in_channels=9), SDModelConfig.tiny(in_channels=9)
    jp, tp = pipeline_pair(jcfg, tcfg, seed=8)
    tree = random_controlnet_tree(jcfg, seed=33)
    jp.load_controlnet(params=tree)
    tp.load_controlnet(params=_state(tree))
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    kw = dict(KW, init_image=_init_image(), mask_image=mask, strength=1.0,
              vae_sample_mode="mean", control_image=hints()[0], num_inference_steps=2)
    with pytest.raises(ScopeParamShapeError):
        jp.generate(**kw)
    with pytest.raises(ValueError, match="C.7"):
        tp.generate(**kw)


def test_inpaint_full_res_crops_the_hints_as_the_init_image(pair):
    """``inpaint_full_res`` crops both hints with the init image's region and
    LANCZOS scaling (``pww_tpu/pipeline/pipeline.py:1474-1490``): hints equal
    to the init image come out equal to its crop, hint lists item by item."""
    _, tp = pair
    init = _init_image()
    mask = np.zeros((64, 64), np.float32)
    mask[8:24, 30:50] = 1.0
    crop_init, _, _, control, adapter, (_, _, region) = tp._crop_for_full_res(
        init, mask, None, [init, init], init, 0.0, 4)
    assert region != (0, 0, 64, 64)
    for hint in control + [adapter]:
        np.testing.assert_array_equal(hint, crop_init)


# -- errors -------------------------------------------------------------------------

ERROR_CASES = {  # nets attached, generate's arguments, the error, its message
    "no ControlNet": (0, dict(control_image=hints()[0]), ValueError, "load_controlnet"),
    "three images for two nets": (2, dict(control_image=[hints()[0]] * 3), ValueError,
                                  "control images"),
    "three scales for two nets": (2, dict(control_image=list(hints()),
                                          controlnet_conditioning_scale=[1.0] * 3),
                                  ValueError, "scales"),
    "an image list for one net": (1, dict(control_image=list(hints())), ValueError,
                                  "add_controlnet"),
    "a hint of another size": (1, dict(control_image=np.zeros((96, 96, 3), np.uint8)),
                               ValueError, "processing resolution"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_control_arguments_are_checked(pair, nets, case):
    """The JAX pipeline's refusals (``tests/test_controlnet.py:74-196``)."""
    _, tp = pair
    k, kw, exc, match = ERROR_CASES[case]
    tp.controlnets = []
    if k:
        _attach_port(tp, nets[:k])
    with pytest.raises(exc, match=match):
        tp.generate(**dict(KW, num_inference_steps=1), **kw)


# -- the SDXL (text_time) ControlNet (ROADMAP A.16a) --------------------------------------

def _xl_added_cond(rng, n):
    return {"text_embeds": rng.standard_normal((n, 64)).astype(np.float32),
            "time_ids": np.tile(np.float32([[128, 128, 0, 0, 128, 128]]), (n, 1))}


def test_xl_controlnet_matches_jax():
    """The tiny SDXL net's residuals with ``added_cond`` (the pooled text
    and the Fourier ``time_ids`` through its own ``add_embedding``) at
    scale 0.7 against the JAX net; other ``added_cond`` gives other
    residuals, and none raises as in JAX."""
    jcfg, tcfg = JaxSDModelConfig.tiny_xl(), SDModelConfig.tiny_xl()
    tree = random_controlnet_tree(jcfg, seed=41)
    rng = np.random.default_rng(42)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, tcfg.unet.cross_attention_dim)).astype(np.float32)
    hint = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    added = _xl_added_cond(rng, 2)
    cn = JaxControlNet(jcfg.unet)
    want_down, want_mid = cn.apply(tree, jnp.asarray(lat), jnp.float32(801.0), jnp.asarray(ctx),
                                   jnp.asarray(hint), conditioning_scale=0.7,
                                   added_cond={k: jnp.asarray(v) for k, v in added.items()})
    net = torch_controlnet(tcfg, tree)
    assert "add_embedding.linear_1.weight" in net.state_dict()
    args = (torch.from_numpy(lat).permute(0, 3, 1, 2), torch.tensor(801.0),
            torch.from_numpy(ctx), torch.from_numpy(hint).permute(0, 3, 1, 2), None, 0.7)
    with torch.inference_mode():
        down, mid = net(*args, added_cond={k: torch.from_numpy(v) for k, v in added.items()})
        other, _ = net(*args, added_cond={"text_embeds": torch.zeros(2, 64),
                                          "time_ids": torch.from_numpy(added["time_ids"])})
    for got, want in zip(down + (mid,), tuple(want_down) + (want_mid,)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    assert not torch.allclose(other[-1], down[-1], atol=1e-4)
    with pytest.raises(ValueError, match="requires added_cond"):
        net(*args)


@pytest.fixture(scope="module")
def xl_pair():
    return pipeline_pair(JaxSDModelConfig.tiny_xl(), SDModelConfig.tiny_xl(), seed=43)


@pytest.fixture(scope="module")
def xl_tree():
    return random_controlnet_tree(JaxSDModelConfig.tiny_xl(), seed=44)


XL_CASES = {"batched": ({}, {}),
            "split": (dict(weight_function=_jax_lambda), dict(weight_function=_torch_lambda))}


@pytest.mark.parametrize("case", list(XL_CASES))
def test_tiny_xl_controlnet_pipeline_matches_jax(xl_pair, xl_tree, case):
    """2 LMS steps of the tiny SDXL pipeline with the net at scale 0.7, in
    the default noise mode: the batched path gives the net all 2N rows of
    ``added_cond``, the split path each CFG half its own; unlike the run
    without control."""
    jp, tp = xl_pair
    _attach(jp, tp, [xl_tree])
    kw = dict(KW, num_inference_steps=2, control_image=hints(128)[0],
              controlnet_conditioning_scale=0.7, color_map_image=color_map(128))
    del kw["noise_mode"]
    jside, tside = XL_CASES[case]
    want = np.asarray(jp.generate(**kw, **jside))
    got = tp.generate(**kw, **tside)
    _close(got, want)
    plain = {k: v for k, v in kw.items() if k != "control_image"}
    assert not np.allclose(got, tp.generate(**plain, **tside), atol=1e-4)


def test_xl_controlnet_file_loads_in_the_port_alone(xl_pair, xl_tree, tmp_path):
    """ROADMAP C.19: a diffusers SDXL ControlNet directory (``text_time``,
    its ``add_embedding``, the 3×3 ``conv_out``) loads bit-equal through
    the port's ``load_controlnet(path)``; the JAX reader cannot load any
    SDXL ControlNet (its ``eval_shape`` passes no ``added_cond``). The
    loaded net's pipeline matches JAX run on the same tree (``params=``)."""
    jp, tp = xl_pair
    want_state = _state(xl_tree)
    d = str(tmp_path / "xl_cn")
    loader.save_controlnet_checkpoint(d, SDModelConfig.tiny_xl(), want_state)
    import json

    with open(f"{d}/config.json") as f:
        assert json.load(f)["addition_embed_type"] == "text_time"
    with pytest.raises(ValueError, match="requires added_cond"):
        jax_loader.load_controlnet_checkpoint(d, JaxSDModelConfig.tiny_xl())
    got_state = loader.load_controlnet_checkpoint(d, SDModelConfig.tiny_xl())
    assert set(got_state) == set(want_state)
    assert all(torch.equal(got_state[k], want_state[k]) for k in want_state)
    with pytest.raises(ValueError, match="addition_embed_type"):
        loader.load_controlnet_checkpoint(d, SDModelConfig.tiny())
    jp.load_controlnet(params=xl_tree)
    tp.load_controlnet(d)
    kw = dict(KW, num_inference_steps=2, control_image=hints(128)[1],
              color_map_image=color_map(128))
    _close(tp.generate(**kw), np.asarray(jp.generate(**kw)))
