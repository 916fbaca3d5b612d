"""SDXL base and refiner in the port against the JAX package (CPU, f32 on
both sides), and their published shapes on the meta device.

* the text towers: penultimate hidden state and the projected pooled vector,
  its position by the first ``eos_token_id``, by the largest id, and by the
  largest id for the legacy ``eos_token_id`` 2;
* the UNets of ``tiny_xl`` and ``tiny_xl_refiner`` with ``added_cond``, and
  an XL-shaped UNet at head dim 64 whose sites take the K1-K3 wrappers (their
  plain versions on the CPU);
* the tiny XL pipeline (force-zeros, a negative prompt, micro-conditioning,
  the split CFG path), the refiner's img2img with its aesthetic score, and
  the ensemble-of-experts handoff, on the final latents;
* both loaders on the same tiny SDXL-base and refiner directories;
* SDXL-base and refiner at diffusers' published shapes: parameter counts and
  the kernel sites of one UNet visit at 1024², which ``chip_smoke.py``'s
  launch gates use.

Tolerances: f32 summation-order noise, 2e-5 of the largest latent after a
few UNet calls (as the other pipeline tests), 1e-5 absolute for one UNet
call, 2e-6 for the text towers.
"""
import copy
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pww_tpu.config import CLIPTextConfig as JaxCLIPTextConfig
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.clip import CLIPTextEncoder
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu.types import PwwState as JPwwState
from pww_tpu.weights import loader as jax_loader
from pww_tpu_torch.config import CLIPTextConfig, SDModelConfig
from pww_tpu_torch.models import unet as tunet
from pww_tpu_torch.models.clip import CLIPTextModel
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.pipeline import facade
from pww_tpu_torch.pipeline.facade import paint_with_words
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
from pww_tpu_torch.types import PwwState
from pww_tpu_torch.weights import loader
from pww_tpu_torch.weights.bridge import build_models, params_from_jax
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401

LAT_TOL = 2e-5
KW = dict(prompt="a cat and a dog", color_map_image=color_map(128),
          color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
          num_inference_steps=3, seed=0, noise_mode="torch", return_latents=True)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAT_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def xl():
    return pipeline_pair(JaxSDModelConfig.tiny_xl(), SDModelConfig.tiny_xl(), seed=11)


@pytest.fixture(scope="module")
def refiner():
    return pipeline_pair(JaxSDModelConfig.tiny_xl_refiner(), SDModelConfig.tiny_xl_refiner(),
                         seed=12)


# -- config and text towers ------------------------------------------------------

@pytest.mark.parametrize("name", ["sdxl", "sdxl_refiner", "tiny_xl", "tiny_xl_refiner"])
def test_xl_configs_match_jax(name):
    cfg, jcfg = getattr(SDModelConfig, name)(), getattr(JaxSDModelConfig, name)()
    for part in ("clip", "clip2", "vae"):
        mine, ref = getattr(cfg, part), getattr(jcfg, part)
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert dataclasses.asdict(mine) == {k: v for k, v in dataclasses.asdict(ref).items()
                                                if k in dataclasses.asdict(mine)}
    ref_unet = dataclasses.asdict(jcfg.unet)
    for k, v in dataclasses.asdict(cfg.unet).items():
        if k in ref_unet:
            assert v == ref_unet[k], k
    for k in ("is_xl", "needs_pooled", "pooled_dim", "num_time_ids", "xl_refiner",
              "force_zeros_for_empty_prompt"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert cfg.vae.scaling_factor == 0.13025 or name.startswith("tiny")


TOWERS = {
    "tiny_xl clip2": SDModelConfig.tiny_xl().clip2,
    "refiner tower": SDModelConfig.tiny_xl_refiner().clip,
    # the bigG's widths (1280, 20 heads, 5120) at 2 layers and a small vocabulary
    "bigG 2 layers": dataclasses.replace(CLIPTextConfig.sdxl_bigg(), num_layers=2,
                                         vocab_size=1000),
}


@functools.lru_cache(maxsize=None)
def _tower_tree(tower):
    enc = CLIPTextEncoder(JaxCLIPTextConfig(**dataclasses.asdict(TOWERS[tower])))
    shapes = jax.eval_shape(functools.partial(enc.init, output="penultimate_and_pooled"),
                            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
                        shapes)


@pytest.mark.parametrize("eos", ["config", None, 2, "penultimate"])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_clip_penultimate_and_pooled_match_jax(tower, eos):
    """The EOS id 1 sits at position 3 and a larger id after it, so the three
    pooled positions differ: the first eos_token_id, and the largest id for
    None and for the legacy 2."""
    cfg = TOWERS[tower]
    if eos != "config":
        cfg = dataclasses.replace(cfg, eos_token_id=1 if eos == "penultimate" else eos)
    mode = "penultimate" if eos == "penultimate" else "penultimate_and_pooled"
    enc = CLIPTextEncoder(JaxCLIPTextConfig(**dataclasses.asdict(cfg)))
    ids = np.array([[0, 5, 9, 1, 999, 3] + [1] * 71, [0, 7, 1, 2, 4, 998] + [8] * 71])
    tree = _tower_tree(tower)
    want = enc.apply(tree, jnp.asarray(ids, jnp.int32), output=mode)
    model = CLIPTextModel(cfg)
    model.load_state_dict(params_from_jax({"clip": tree})["clip"], strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), output=mode)
    if mode == "penultimate":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)


# -- UNet ----------------------------------------------------------------------------

def _added_cond(cfg, rng):
    pooled = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    tid = np.array([[96, 128, 8, 0, 128, 128, 6.0][:cfg.num_time_ids]] * 2, np.float32)
    if cfg.xl_refiner:
        tid[0, -1] = 2.5
    return pooled, tid


def _unet_against_jax(jcfg, tcfg, jparams, model, hw, monkeypatch=None):
    """One UNet call of the JAX UNet (``jparams``) and the port's ``model``
    on the same inputs, with a PwW state keyed at every attention
    resolution; returns the port's kernel wrappers' call counts."""
    rng = np.random.default_rng(4)
    sample = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, tcfg.unet.cross_attention_dim)).astype(np.float32)
    pooled, tid = _added_cond(tcfg, rng)
    sizes = [(hw >> i) ** 2 for i in range(len(tcfg.unet.block_out_channels))]
    weights = {q: np.stack([np.zeros((q, 77), np.float32),
                            rng.random((q, 77)).astype(np.float32)]) for q in sizes}
    t, sigma = 801.0, 4.5
    unet = JaxUNet(jcfg.unet, dtype=jnp.float32)
    jpww = JPwwState(weights={k: jnp.asarray(v) for k, v in weights.items()}, weight_orig=None,
                     sigma=jnp.float32(sigma),
                     weight_fn=jax_weight_function())
    apply = jax.jit(lambda p, x, c, w, ac: unet.apply(p, x, jnp.float32(t), c, pww=w,
                                                     added_cond=ac))
    want = np.asarray(apply(jparams, jnp.asarray(sample), jnp.asarray(ctx), jpww,
                            {"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(tid)}))
    calls = {"flash": 0, "reduce": 0, "xattn": 0}
    if monkeypatch is not None:
        for name, attr in (("flash", "flash_self_attention"), ("reduce", "fused_pww_reduce"),
                           ("xattn", "fused_pww_cross_attention")):
            fn = getattr(tunet, attr)

            def spy(*a, _n=name, _fn=fn, **k):
                calls[_n] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(tunet, attr, spy)
    tpww = PwwState(weights={k: torch.from_numpy(v) for k, v in weights.items()},
                    weight_orig=None, sigma=torch.tensor(sigma),
                    weight_fn=WeightFunction(0.3, "log1p_sigma", "max"))
    with torch.inference_mode():
        got = model(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(t),
                    torch.from_numpy(ctx), tpww,
                    added_cond={"text_embeds": torch.from_numpy(pooled),
                                "time_ids": torch.from_numpy(tid)})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    with pytest.raises(ValueError, match="added_cond"):
        model(torch.from_numpy(sample).permute(0, 3, 1, 2), torch.tensor(t),
              torch.from_numpy(ctx), tpww)
    return calls


def jax_weight_function():
    from pww_tpu.ops.weight_functions import WeightFunction as JaxWeightFunction

    return JaxWeightFunction(0.3, "log1p_sigma", "max")


@pytest.mark.parametrize("name", ["tiny_xl", "tiny_xl_refiner"])
def test_xl_unets_with_added_cond_match_jax(xl, refiner, name):
    jp, tp = xl if name == "tiny_xl" else refiner
    model = tp.unet
    _unet_against_jax(jp.config, tp.config, jp.params["unet"], model, 16)
    down = model.down_blocks
    assert down[0].attentions is None  # no attention in stage 0
    assert [len(a.transformer_blocks) for a in down[1].attentions] == [2]
    assert len(model.mid_block.attentions[0].transformer_blocks) == 2
    assert [len(a.transformer_blocks) for a in model.up_blocks[0].attentions] == [2, 2]
    assert model.up_blocks[1].attentions is None


def test_xl_unet_kernel_branches_match_jax_at_head_dim_64(monkeypatch):
    """An XL-shaped UNet of 64 and 128 channels at head dim 64: every
    attention site is 8² (Lq 64), so with the port's ``flash_min_seq`` and
    ``fused_cross_min_seq`` lowered to 64 the 8 self- and 8 cross-attention
    sites (1 down × depth 2, the mid block's 2, 2 up × 2) take the K1-K3
    wrappers, whose plain versions run here; the JAX UNet's dense path is
    the same function."""
    def hd64(cfg, **kw):
        return dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, block_out_channels=(64, 128), attention_head_dim=64, **kw))
    jcfg = hd64(JaxSDModelConfig.tiny_xl())
    tcfg = hd64(SDModelConfig.tiny_xl(), flash_min_seq=64, fused_cross_min_seq=64)
    unet = JaxUNet(jcfg.unet)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, 96)),
                            added_cond={"text_embeds": jnp.zeros((1, 64)),
                                        "time_ids": jnp.zeros((1, 6))})
    rng = np.random.default_rng(14)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 if path[-1].key == "scale" else 0.0)
        + 0.1 * rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = build_models(tcfg, device="cpu", parts=("unet",))["unet"]
    model.load_state_dict(params_from_jax({"unet": jparams})["unet"], strict=True)
    calls = _unet_against_jax(jcfg, tcfg, jparams, model, 16, monkeypatch)
    assert tcfg.unet.heads_for(128) == (2, 64)
    assert calls == {"flash": 8, "reduce": 8, "xattn": 8}


# -- pipelines -------------------------------------------------------------------------

def _custom_jax(w, sigma, qk):
    return 0.4 * w * jnp.log1p(sigma) * jnp.max(qk)


def _custom_torch(w, sigma, qk):
    return 0.4 * w * torch.log1p(sigma) * torch.amax(qk)


XL_CASES = {
    "force zeros": ({}, {}),
    "negative prompt": ({"negative_prompt": "blurry"}, {"negative_prompt": "blurry"}),
    "micro-conditioning": ({"original_size": (256, 192), "crops_coords_top_left": (8, 16),
                            "target_size": (96, 128)},) * 2,
    "split path": ({"weight_function": _custom_jax}, {"weight_function": _custom_torch}),
}


@pytest.mark.parametrize("case", list(XL_CASES))
def test_tiny_xl_txt2img_matches_jax(xl, case):
    """Three LMS steps with a two-region map: an empty negative prompt zeroes
    the uncond text states and pooled vector (force_zeros_for_empty_prompt);
    the micro-conditioning's sizes and crop reach the UNet; a custom weight
    function takes the two-call CFG with each half's added_cond."""
    jp, tp = xl
    jkw, tkw = XL_CASES[case]
    want = np.asarray(jp.generate(**KW, **jkw))
    got = tp.generate(**KW, **tkw)
    assert got.shape == (1, 16, 16, 4)
    _close(got, want)
    if case == "force zeros":
        enc = tp.encode_inputs(KW["prompt"], None, {})
        assert not enc.text_states[0].any() and not enc.pooled[0].any()
        assert enc.text_states.shape == (2, 77, 96) and enc.pooled.shape == (2, 64)
    if case == "micro-conditioning":
        assert not np.allclose(got, tp.generate(**KW), atol=1e-4)


def test_refiner_img2img_and_aesthetic_score_match_jax(refiner):
    """The refiner's one tower and 5 time_ids: img2img at strength 0.75 (VAE
    posterior mean) with two aesthetic scores, which move the latents."""
    from PIL import Image

    jp, tp = refiner
    rng = np.random.default_rng(0)
    init = Image.fromarray((rng.random((128, 128, 3)) * 255).astype(np.uint8))
    kw = dict(KW, init_image=init, strength=0.75, vae_sample_mode="mean",
              negative_prompt="blurry")
    outs = []
    for score in (6.0, 1.0):
        want = np.asarray(jp.generate(aesthetic_score=score, **kw))
        got = tp.generate(aesthetic_score=score, **kw)
        _close(got, want)
        outs.append(got)
    assert not np.allclose(outs[0], outs[1], atol=1e-4)


def test_split_trajectory_equals_full_run():
    """``denoising_end=f`` then ``init_latents`` + ``denoising_start=f`` on
    one euler pipeline lands on the full run (stateless steps)."""
    pipe = PwwPipeline(SDModelConfig.tiny_xl(), scheduler="euler", device="cpu",
                       dtype=torch.float32, seed=5)
    kw = dict(KW, num_inference_steps=6)
    full = pipe.generate(**kw)
    lat = pipe.generate(denoising_end=0.5, **kw)
    assert not np.allclose(lat, full, atol=1e-3)
    out = pipe.generate(init_latents=lat, denoising_start=0.5, **kw)
    np.testing.assert_allclose(out, full, rtol=0, atol=1e-6 * np.abs(full).max())


def test_base_to_refiner_handoff_matches_jax(xl, refiner):
    """The base runs the visits at or above the cutoff round(1000 − 0.75·1000)
    = 250, the refiner resumes the base's latents below it (4 LMS steps: 3
    and 1), each side on its own latents."""
    (jb, tb), (jr, tr) = xl, refiner
    kw = dict(KW, num_inference_steps=4)
    want_lat = np.asarray(jb.generate(denoising_end=0.75, **kw))
    lat = tb.generate(denoising_end=0.75, **kw)
    _close(lat, want_lat)
    want = np.asarray(jr.generate(init_latents=jnp.asarray(want_lat), denoising_start=0.75,
                                  **kw))
    got = tr.generate(init_latents=lat, denoising_start=0.75, **kw)
    _close(got, want)
    img = tr.generate(**{**kw, "return_latents": False}, output_type="np",
                      init_latents=lat, denoising_start=0.75)
    assert img.shape == (1, 128, 128, 3) and img.dtype == np.uint8


def test_denoising_arguments_are_checked_as_in_jax():
    pipe = PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32)
    kw = dict(KW, num_inference_steps=2)
    with pytest.raises(ValueError, match="denoising_start requires"):
        pipe.generate(denoising_start=0.5, **kw)
    with pytest.raises(ValueError, match=r"in \(0, 1\)"):
        pipe.generate(denoising_end=1.5, **kw)
    with pytest.raises(ValueError, match="callback"):
        pipe.generate(denoising_end=0.5, callback=lambda *a: None, **kw)
    with pytest.raises(ValueError, match="exclusive"):
        pipe.generate(init_latents=np.zeros((1, 16, 16, 4), np.float32),
                      init_image=np.zeros((128, 128, 3), np.uint8), **kw)
    with pytest.raises(ValueError, match="init_latents shape"):
        pipe.generate(init_latents=np.zeros((1, 8, 8, 4), np.float32), **kw)
    with pytest.raises(ValueError, match="masked-blend"):
        pipe.generate(init_image=np.zeros((128, 128, 3), np.uint8),
                      mask_image=np.ones((128, 128), np.float32), denoising_end=0.5, **kw)


def test_xl_refusals_name_their_roadmap_items(xl):
    """What raised A.16a and A.16b runs: a fresh SDXL ControlNet (zero
    convs zero) leaves the latents as they are, and a 9-channel SDXL UNet
    inpaints (against JAX in test_tiny_xl_inpaint_nine_channel_matches_jax;
    the SDXL ControlNet in tests/test_torch_controlnet.py)."""
    _, tp = xl
    hint = np.zeros((128, 128, 3), np.uint8)
    hint[32:96, 32:96] = 255
    kw = dict(KW, num_inference_steps=2)
    base = tp.generate(**kw)
    tp.load_controlnet()
    np.testing.assert_array_equal(tp.generate(control_image=hint, **kw), base)
    tp.controlnets = []
    nine = PwwPipeline(_nine_channel(SDModelConfig.tiny_xl()), device="cpu", dtype=torch.float32)
    out = nine.generate(init_image=np.zeros((128, 128, 3), np.uint8),
                        mask_image=np.ones((128, 128), np.float32), **kw)
    assert out.shape == (1, 16, 16, 4) and np.isfinite(out).all()


def _nine_channel(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, in_channels=9))


@pytest.fixture(scope="module")
def xl9():
    return pipeline_pair(_nine_channel(JaxSDModelConfig.tiny_xl()),
                         _nine_channel(SDModelConfig.tiny_xl()), seed=13)


def _xl_init(size=128):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return (np.stack([xx, yy, 0.5 + 0.5 * np.sin(xx * 9.0)], -1) * 220.0).astype(np.uint8)


def _xl_mask(size=128):
    m = np.zeros((size, size), np.float32)
    m[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 1.0
    return m


def test_tiny_xl_inpaint_nine_channel_matches_jax(xl9):
    """SDXL 9-channel inpainting (ROADMAP A.16b) composes with the XL
    ``added_cond`` and the pooled text, as
    ``tests/test_sdxl.py::test_tiny_xl_inpaint_nine_channel`` runs it:
    ``generate`` in the default noise mode (the posterior sample from
    ``split(PRNGKey(seed))``) against JAX, then ``paint_with_words_inpaint``
    on the same pipeline (the same latents), and ``generate_batch``'s two
    rows against the JAX batch."""
    jp, tp = xl9
    kw = dict(KW, init_image=_xl_init(), mask_image=_xl_mask(), strength=1.0,
              num_inference_steps=2)
    del kw["noise_mode"]
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    _close(got, want)
    via = facade.paint_with_words_inpaint(
        color_context=kw["color_context"], color_map_image=kw["color_map_image"],
        init_image=kw["init_image"], mask_image=kw["mask_image"], input_prompt=kw["prompt"],
        num_inference_steps=2, seed=0, device="cpu", preloaded_utils=tp, return_latents=True)
    np.testing.assert_array_equal(via, got)
    reqs = [dict(prompt=kw["prompt"], color_map_image=kw["color_map_image"], seed=s,
                 color_context=kw["color_context"], init_image=_xl_init(),
                 mask_image=_xl_mask()) for s in (0, 4)]
    bw = np.asarray(jp.generate_batch(reqs, num_inference_steps=2, strength=1.0,
                                      output_type="np"))
    bg = tp.generate_batch(reqs, num_inference_steps=2, strength=1.0, output_type="np")
    diff = np.abs(bg.astype(int) - bw.astype(int))
    assert bg.shape == (2, 128, 128, 3) and diff.max() <= 1 and (diff > 0).mean() < 1e-2
    assert not np.array_equal(bg[0], bg[1])


def test_tiny_xl_group_text_encode_matches_jax(xl, monkeypatch):
    """``generate_batch`` on two requests with distinct prompts, one with an
    empty negative prompt (its uncond row zeroed, force-zeros) and one with
    its own: the port encodes both pairs in one call of the two towers
    (``_prewarm_text_cache``: rows [negative, prompt] a pair, the second
    tokenizer's ids for the second tower), the JAX package encodes each
    request alone. The second tokenizer pads with 0, as SDXL's does, so its
    rows differ from the first's. The images agree as the batch above does."""
    jp, tp = xl
    for pipe in (jp, tp):
        tok2 = copy.copy(pipe.tokenizer)
        tok2.pad_token_id = 0
        monkeypatch.setattr(pipe, "tokenizer_2", tok2)
    reqs = [dict(prompt="a cat and a dog on a lawn", negative_prompt="",
                 color_map_image=color_map(128), seed=3,
                 color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"}),
            dict(prompt="a dog chasing a cat", negative_prompt="blurry photo",
                 color_map_image=color_map(128), seed=5,
                 color_context={(255, 0, 0): "dog,1.0", (0, 0, 255): "cat,0.8"})]
    tp.invalidate_encode_caches()
    shapes = []
    encode = tp.encode_text

    def counted(ids, ids2=None, clip_skip=0):
        shapes.append((tuple(ids.shape), None if ids2 is None else tuple(ids2.shape)))
        return encode(ids, ids2, clip_skip)

    monkeypatch.setattr(tp, "encode_text", counted)
    bw = np.asarray(jp.generate_batch(reqs, num_inference_steps=2, output_type="np"))
    bg = tp.generate_batch(reqs, num_inference_steps=2, output_type="np")
    assert shapes == [((4, 77), (4, 77))]  # one group call; the requests hit its cache
    diff = np.abs(bg.astype(int) - bw.astype(int))
    assert bg.shape == (2, 128, 128, 3) and diff.max() <= 1 and (diff > 0).mean() < 1e-2
    assert not np.array_equal(bg[0], bg[1])
    tp.invalidate_encode_caches()  # entries of the padded-with-0 tokenizer


# -- loading ---------------------------------------------------------------------------

def _assert_same_fields(cfg, jcfg):
    for part in ("clip", "clip2", "unet", "vae"):
        mine, ref = getattr(cfg, part), getattr(jcfg, part)
        assert (mine is None) == (ref is None), part
        if mine is None:
            continue
        for f in dataclasses.fields(mine):
            if hasattr(ref, f.name):
                assert getattr(mine, f.name) == getattr(ref, f.name), f"{part}.{f.name}"
    assert (cfg.xl_refiner, cfg.force_zeros_for_empty_prompt) == \
        (jcfg.xl_refiner, jcfg.force_zeros_for_empty_prompt)


@pytest.fixture(scope="module")
def xl_dirs(tmp_path_factory, xl, refiner):
    """The two pairs' weights as diffusers directories, with a real-BPE
    tokenizer (written for both towers of the base)."""
    root = tmp_path_factory.mktemp("xl")
    out = {}
    for name, (jp, _) in (("tiny_xl", xl), ("tiny_xl_refiner", refiner)):
        out[name] = path = str(root / name)
        loader.save_diffusers_checkpoint(path, getattr(SDModelConfig, name)(),
                                         params_from_jax(jax.tree.map(np.asarray, jp.params)),
                                         synthetic_tokenizer(1000))
    return out


@pytest.mark.parametrize("name", ["tiny_xl", "tiny_xl_refiner"])
def test_both_loaders_read_the_same_xl_directory(xl_dirs, name):
    path = xl_dirs[name]
    subdirs = sorted(os.listdir(path))
    if name == "tiny_xl":
        assert subdirs == ["model_index.json", "text_encoder", "text_encoder_2", "tokenizer",
                           "tokenizer_2", "unet", "vae"]
    else:
        assert subdirs == ["model_index.json", "text_encoder_2", "tokenizer_2", "unet", "vae"]
    jcfg, jparams, jtok, jtok2 = jax_loader.load_pipeline_checkpoint(path)
    cfg, params, tok, tok2 = loader.load_pipeline_checkpoint(path)
    _assert_same_fields(cfg, jcfg)
    assert cfg == getattr(SDModelConfig, name)()
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(params) == set(want)
    for part in params:
        assert set(params[part]) == set(want[part]), part
        for k, t in params[part].items():
            np.testing.assert_array_equal(t.numpy(), want[part][k].numpy(), err_msg=k)
    assert tok.pad_token_id == jtok.pad_token_id
    assert tok("a cat and a dog") == jtok("a cat and a dog")
    if name == "tiny_xl":
        assert tok2.pad_token_id == jtok2.pad_token_id == 0
        assert tok2("a cat and a dog") == jtok2("a cat and a dog")
    else:
        assert tok2 is None and jtok2 is None and tok.pad_token_id == 0
    # the tokenizer_2 directory alone, before the loaders' padding with 0:
    # tokenizer_config.json's pad_token_id, read the same way by both
    from pww_tpu.tokenizer.clip_bpe import CLIPTokenizer as JaxCLIPTokenizer
    from pww_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer

    t2dir = os.path.join(path, "tokenizer_2")
    mine, ref = CLIPTokenizer.from_dir(t2dir), JaxCLIPTokenizer.from_dir(t2dir)
    assert mine.pad_token_id == ref.pad_token_id == synthetic_tokenizer(1000).pad_token_id
    assert mine("a cat, a dog") == ref("a cat, a dog")


def test_pww_load_tools_on_an_xl_directory_matches_jax(xl_dirs, monkeypatch):
    monkeypatch.setattr(facade, "_PIPELINE_CACHE", {})
    path = xl_dirs["tiny_xl"]
    jp = JaxPipeline.from_pretrained(path, compute_dtype=jnp.float32, weights_dtype=jnp.float32)
    want = np.asarray(jp.generate(**KW))
    got = paint_with_words(local_model_path=path, device="cpu", input_prompt=KW["prompt"],
                           color_map_image=KW["color_map_image"],
                           color_context=KW["color_context"], num_inference_steps=3,
                           noise_mode="torch", return_latents=True)
    _close(got, want)
    pipe = facade.pww_load_tools("cpu", local_model_path=path)
    assert pipe.config.is_xl and pipe.tokenizer_2.pad_token_id == 0


def test_xl_controlnet_directory_still_raises(tmp_path):
    """An SDXL ControlNet directory loads for an SDXL config (ROADMAP C.19,
    tests/test_torch_controlnet.py); for an SD-1.x config it raises, and so
    does an SD-1.x ControlNet for an SDXL config."""
    import json

    with open(tmp_path / "config.json", "w") as f:
        json.dump({"addition_embed_type": "text_time"}, f)
    with pytest.raises(ValueError, match="addition_embed_type"):
        loader.load_controlnet_checkpoint(str(tmp_path), SDModelConfig.tiny())
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"addition_embed_type": None}, f)
    with pytest.raises(ValueError, match="addition_embed_type"):
        loader.load_controlnet_checkpoint(str(tmp_path), SDModelConfig.tiny_xl())


# -- published shapes on the meta device -------------------------------------------------

def test_published_sdxl_unet_config_json_reads_as_sdxl(tmp_path):
    """diffusers' stable-diffusion-xl-base-1.0 ``unet/config.json`` fields
    (stage 0's depth 1 has no attention to act on) give SDXL's shapes."""
    import json

    os.makedirs(tmp_path / "unet")
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump({"block_out_channels": [320, 640, 1280], "attention_head_dim": [5, 10, 20],
                   "cross_attention_dim": 2048, "sample_size": 128,
                   "transformer_layers_per_block": [1, 2, 10],
                   "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                        "CrossAttnDownBlock2D"],
                   "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
                   "projection_class_embeddings_input_dim": 2816}, f)
    cfg = loader.config_from_checkpoint(str(tmp_path))
    _assert_same_fields(cfg, jax_loader.config_from_checkpoint(str(tmp_path)))
    assert dataclasses.replace(cfg.unet, transformer_depth=(0, 2, 10)) == \
        SDModelConfig.sdxl().unet
    shapes = {k: v.shape for k, v in build_models(cfg, parts=("unet",))["unet"].state_dict()
              .items()}
    assert shapes == {k: v.shape for k, v in build_models(
        SDModelConfig.sdxl(), parts=("unet",))["unet"].state_dict().items()}


def _sites(cfg, hw, part="unet"):
    """K1/K2/K3 wrapper calls of one CFG-batched UNet (or ControlNet) visit
    on a hw² latent, traced on the meta device (shapes only)."""
    calls = {"fused_pww_reduce": [], "fused_pww_cross_attention": [],
             "flash_self_attention": []}

    def rec(name, out):
        def fn(q, *a, **k):
            calls[name].append((q.shape[1], q.shape[2], q.shape[3]))
            return out(q)
        return fn

    net = build_models(cfg, parts=(part,))[part]
    with torch.device("meta"):
        sizes = [(hw >> i) ** 2 for i in range(len(cfg.unet.block_out_channels))]
        pww = PwwState(weights={q: torch.empty(2, q, 77) for q in sizes}, weight_orig=None,
                       sigma=torch.empty(()))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tunet, "fused_pww_reduce",
                       rec("fused_pww_reduce", lambda q: torch.empty(q.shape[0])))
            mp.setattr(tunet, "fused_pww_cross_attention",
                       rec("fused_pww_cross_attention", torch.empty_like))
            mp.setattr(tunet, "flash_self_attention",
                       rec("flash_self_attention", torch.empty_like))
            added = {"text_embeds": torch.empty(2, cfg.pooled_dim),
                     "time_ids": torch.empty(2, cfg.num_time_ids)}
            args = (torch.empty(2, 4, hw, hw), torch.tensor(1.0),
                    torch.empty(2, 77, cfg.unet.cross_attention_dim))
            if part == "controlnet":
                net(*args, torch.empty(2, 3, 8 * hw, 8 * hw), pww, 1.0, added)
            else:
                net(*args, pww, added_cond=added)
    return calls


def _per_kernel(calls):
    return {k: {s: sites.count(s) for s in set(sites)} for k, sites in calls.items()}


def test_published_sdxl_controlnet_shapes_and_kernel_sites():
    """The SDXL ControlNet at diffusers' published shapes: its parameter
    count, and per 1024² visit (CFG batch 2) its K1-K3 sites, 34 of each
    (4 at Lq 4096, 30 at Lq 1024): chip_smoke.py's SDXL_CONTROLNET_SITES
    and launch gates; at xl_reduced_configs' widths and 512², the base's
    and the net's visits of XL_REDUCED_VISIT."""
    cfg = SDModelConfig.sdxl()
    net = build_models(cfg, parts=("controlnet",))["controlnet"]
    assert sum(t.numel() for t in net.state_dict().values()) == \
        chip_smoke.SDXL_CONTROLNET_PARAMS
    assert net.add_embedding.linear_1.in_features == cfg.unet.projection_class_embeddings_input_dim
    per_kernel = _per_kernel(_sites(cfg, 128, "controlnet"))
    assert all(sites == chip_smoke.SDXL_CONTROLNET_SITES for sites in per_kernel.values())
    assert tuple(sum(s.values()) for s in per_kernel.values()) == \
        chip_smoke.SDXL_CONTROLNET_LAUNCHES_PER_VISIT
    base, _ = chip_smoke.xl_reduced_configs()
    for part, name in (("unet", "base"), ("controlnet", "controlnet")):
        calls = _sites(base, 64, part)
        assert tuple(len(v) for v in calls.values()) == chip_smoke.XL_REDUCED_VISIT[name]


@pytest.mark.parametrize("name", ["sdxl", "sdxl_refiner"])
def test_published_xl_shapes_and_kernel_sites(name):
    """diffusers' parameter counts, and per UNet visit at 1024² (latent 128²,
    CFG batch 2) the (heads, Lq, head dim) of every K1, K2 and K3 call:
    chip_smoke.py's SDXL_SITES, which its launch gates and kernel cases
    use. The PwW pyramid of a 1024² map has the 64² and 32² levels."""
    from pww_tpu_torch.conditioning.rasterize import PYRAMID_RATIOS, pyramid_level_shape

    cfg = getattr(SDModelConfig, name)()
    counts = {part: sum(t.numel() for t in m.state_dict().values())
              for part, m in build_models(cfg).items()}
    assert counts == chip_smoke.SDXL_PARAMS[name]
    calls = _sites(cfg, 128)
    table = chip_smoke.SDXL_SITES[name]
    for kernel, sites in calls.items():
        got = {}
        for s in sites:
            got[s] = got.get(s, 0) + 1
        assert got == {s: n for s, n in table.items() if kernel != "flash_self_attention"
                       or s[1] >= cfg.unet.flash_min_seq}, kernel
    per_visit = tuple(len(calls[k]) for k in calls)
    assert per_visit == chip_smoke.SDXL_LAUNCHES_PER_VISIT[name]
    assert {h * w for h, w in (pyramid_level_shape(1024, 1024, r) for r in PYRAMID_RATIOS)} \
        >= {q for _, q, _ in table}
