"""The port's IP-Adapter (pww_tpu_torch.models.clip_vision,
pww_tpu_torch.weights.ip_adapter, PwwPipeline.load_ip_adapter and the
``ip_adapter_image`` route of generate, generate_batch and the server)
against pww_tpu on the CPU in f32, with the tiny vision tower and the tiny
SD-1.5 and SDXL configs on random trees (tests/torch_port_cases.py).

Tolerances: module outputs within 1e-5 · max|want| (f32 sums in another
order); ``preprocess_clip_image`` bit for bit; final latents within
2e-5 · max|latents|, as tests/test_torch_pipeline.py holds txt2img;
``generate_batch``'s uint8 images within one level on under 2% of pixels,
as tests/test_torch_batch.py holds them; scale 0, the Batcher and the
server bit for bit against the port's own ``generate``.
"""
import base64
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.config import CLIPVisionConfig as JaxVisionConfig
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.config import UNetConfig as JaxUNetConfig
from pww_tpu.models import clip_vision as jcv
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu.weights import ip_adapter as jipw
from pww_tpu_torch.config import CLIPVisionConfig, SDModelConfig, UNetConfig
from pww_tpu_torch.models import clip_vision as tcv
from pww_tpu_torch.models.unet import UNet2DConditionModel
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.weights import ip_adapter as tipw
from pww_tpu_torch.weights.bridge import params_from_jax
from pww_tpu_torch.weights.safetensors_io import save_file
from torch_port_cases import color_map, few_torch_threads, random_jax_params  # noqa: F401

KWARGS = dict(prompt="a cat and a dog", color_map_image=color_map(64),
              color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,0.5"},
              num_inference_steps=2, seed=0, noise_mode="torch", return_latents=True)
IMAGE = (np.random.default_rng(5).random((40, 48, 3)) * 255).astype(np.uint8)


def _fill(shapes, seed, scale=0.1):
    """A numpy tree of ``shapes``: norm scales 1 + scale·N(0, 1), the rest
    scale·N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32) * scale
        return 1.0 + x if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _vision(seed=3):
    """(JAX vision config, its numpy tree, the port's config, state dict)."""
    jcfg = JaxVisionConfig.tiny()
    enc = jcv.CLIPVisionEncoder(jcfg)
    tree = _fill(jax.eval_shape(enc.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))), seed)
    return jcfg, tree, CLIPVisionConfig.tiny(), params_from_jax({"image_encoder": tree})[
        "image_encoder"]


def _site_width(cfg, site):
    """The attn2 width at a site of ``attn2_sites``."""
    chs = cfg.block_out_channels
    if site == "mid_attn":
        return chs[-1]
    bi = int(site.split("_")[1])
    return tuple(reversed(chs))[bi] if site.startswith("up_") else chs[bi]


def _ip_state(ucfg, embed_dim, num_tokens=4, seed=0, plus=None):
    """A flat tencent-ailab checkpoint for every attn2 site of ``ucfg``;
    ``plus``: a Resampler ``image_proj`` group instead of the projection."""
    rng = np.random.default_rng(seed)
    d_ctx = ucfg.cross_attention_dim

    def w(*shape, s=0.1):
        return rng.standard_normal(shape).astype(np.float32) * s

    if plus is None:
        state = {"image_proj.proj.weight": w(num_tokens * d_ctx, embed_dim),
                 "image_proj.proj.bias": w(num_tokens * d_ctx),
                 "image_proj.norm.weight": 1 + w(d_ctx), "image_proj.norm.bias": w(d_ctx)}
    else:
        state = {f"image_proj.{k}": v for k, v in plus.items()}
    for i, (site, _) in enumerate(jipw.attn2_sites(ucfg)):
        inner = _site_width(ucfg, site)
        state[f"ip_adapter.{2 * i + 1}.to_k_ip.weight"] = w(inner, d_ctx, s=0.2)
        state[f"ip_adapter.{2 * i + 1}.to_v_ip.weight"] = w(inner, d_ctx, s=0.2)
    return state


def _plus_proj(embed_dim, out_dim, dim=16, num_queries=6, depth=2, heads=2, ff_mult=2,
               seed=3, latent_scale=1.0):
    """A plus ``image_proj`` group (tencent-ailab names, (Q, D) latents)."""
    rng = np.random.default_rng(seed)
    inner = heads * 64

    def w(*shape, s=0.1):
        return rng.standard_normal(shape).astype(np.float32) * s

    proj = {"latents": w(num_queries, dim, s=latent_scale), "proj_in.weight": w(dim, embed_dim),
            "proj_in.bias": w(dim), "proj_out.weight": w(out_dim, dim),
            "proj_out.bias": w(out_dim), "norm_out.weight": 1 + w(out_dim),
            "norm_out.bias": w(out_dim)}
    for i in range(depth):
        a, f = f"layers.{i}.0.", f"layers.{i}.1."
        proj.update({a + "norm1.weight": 1 + w(dim), a + "norm1.bias": w(dim),
                     a + "norm2.weight": 1 + w(dim), a + "norm2.bias": w(dim),
                     a + "to_q.weight": w(inner, dim), a + "to_kv.weight": w(2 * inner, dim),
                     a + "to_out.weight": w(dim, inner), f + "0.weight": 1 + w(dim),
                     f + "0.bias": w(dim), f + "1.weight": w(dim * ff_mult, dim),
                     f + "3.weight": w(dim, dim * ff_mult)})
    return proj


def _t(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


# -- the modules ------------------------------------------------------------------------

@pytest.mark.parametrize("output", ["embeds", "hidden_and_pooled"])
def test_clip_vision_matches_jax(output):
    """The vision tower's embeddings and penultimate states on bridged
    weights; the port takes NCHW where JAX takes NHWC."""
    jcfg, tree, tcfg, state = _vision()
    px = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jcv.CLIPVisionEncoder(jcfg).apply(tree, jnp.asarray(px), output=output)
    with torch.device("meta"):
        enc = tcv.CLIPVisionEncoder(tcfg)
    enc.load_state_dict(state, strict=True, assign=True)
    got = enc(torch.from_numpy(px.transpose(0, 3, 1, 2).copy()), output=output)
    if output == "embeds":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)
    assert got[0].shape == ((2, 17, 32) if output == "hidden_and_pooled" else (2, 24))


@pytest.mark.parametrize("image", ["uint8 40x48", "uint8 48x40", "uint8 32x32", "float 30x50",
                                   "PIL 44x36"])
def test_preprocess_clip_image_bit_for_bit(image):
    """``preprocess_clip_image`` equals the JAX one bit for bit, NCHW."""
    from PIL import Image

    rng = np.random.default_rng(2)
    kind, hw = image.split()
    h, w = (int(v) for v in hw.split("x"))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "float":
        img = img.astype(np.float32) / 255.0
    elif kind == "PIL":
        img = Image.fromarray(img)
    want = np.asarray(jcv.preprocess_clip_image(img, size=32))
    got = tcv.preprocess_clip_image(img, size=32).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_image_projection_matches_jax():
    proj = {k[len("image_proj."):]: v for k, v in _ip_state(JaxUNetConfig.tiny(), 24).items()
            if k.startswith("image_proj.")}
    emb = np.random.default_rng(3).standard_normal((2, 24)).astype(np.float32)
    want = jcv.ImageProjection(32, 4).apply(jipw.image_proj_params(proj), jnp.asarray(emb))
    mod = tcv.ImageProjection(32, 4, 24)
    mod.load_state_dict(tipw.image_proj_params(_t(proj)))
    _close(mod(torch.from_numpy(emb)).detach().numpy(), want)


@pytest.mark.parametrize("latent_scale", [1.0, 3e-3])
def test_resampler_matches_jax_and_its_layer_norm_eps(latent_scale):
    """The Resampler against JAX's, with its LayerNorms at flax's ε = 1e-6
    (ROADMAP C.12): with latents of std 3e-3 the same module at torch's
    1e-5 misses the JAX output by far more than the tolerance."""
    proj = _plus_proj(24, 32, latent_scale=latent_scale)
    rcfg = jipw.resampler_config(proj)
    assert rcfg == tipw.resampler_config(_t(proj))
    feats = np.random.default_rng(4).standard_normal((2, 17, 24)).astype(np.float32)
    want = jcv.Resampler(**rcfg).apply(jipw.resampler_params(proj), jnp.asarray(feats))
    errs = {}
    for eps in (1e-6, 1e-5):
        mod = tcv.Resampler(**rcfg, embedding_dim=24, eps=eps)
        mod.load_state_dict(tipw.resampler_params(_t(proj)))
        got = mod(torch.from_numpy(feats)).detach().numpy()
        errs[eps] = np.abs(got - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert errs[1e-6] <= 1e-5, errs
    if latent_scale < 1.0:
        assert errs[1e-5] > 1e-3, errs
    assert tcv.Resampler(**rcfg, embedding_dim=24).norm_out.eps == 1e-6


def test_plus_latents_as_published_load_where_the_jax_reader_cannot():
    """tencent-ailab and diffusers store the plus latents as (1, Q, D): the
    JAX ``resampler_config`` cannot unpack them (ROADMAP C.16); the port
    reads them as the (Q, D) latents."""
    proj = _plus_proj(24, 32)
    published = dict(proj, latents=proj["latents"][None])
    with pytest.raises(ValueError):
        jipw.resampler_config(published)
    assert tipw.resampler_config(_t(published)) == jipw.resampler_config(proj)
    np.testing.assert_array_equal(tipw.resampler_params(_t(published))["latents"].numpy(),
                                  proj["latents"])


CONFIGS = {"sd15": (JaxUNetConfig.sd15(), UNetConfig.sd15()),
           "sdxl": (JaxUNetConfig.sdxl(), UNetConfig.sdxl()),
           "tiny": (JaxUNetConfig.tiny(), UNetConfig.tiny()),
           "tiny_xl": (JaxSDModelConfig.tiny_xl().unet, SDModelConfig.tiny_xl().unet)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_attn2_sites_match_jax(name):
    """Down, then UP, then mid (diffusers' attention-processor order), as
    the JAX list; each site is an attn2 of the ip-enabled UNet, which has
    ``to_k_ip``/``to_v_ip`` there and nowhere else."""
    import dataclasses

    jcfg, tcfg = CONFIGS[name]
    sites = tipw.attn2_sites(tcfg)
    assert sites == jipw.attn2_sites(jcfg)
    assert len(sites) == {"sd15": 16, "sdxl": 70, "tiny": 4, "tiny_xl": 8}[name]
    if name == "sd15":
        assert sites[5] == ("down_2_attn_1", "blocks_0") and sites[6] == ("up_1_attn_0", "blocks_0")
        assert sites[15] == ("mid_attn", "blocks_0")
    with torch.device("meta"):
        unet = UNet2DConditionModel(dataclasses.replace(tcfg, ip_adapter_tokens=4))
    ip_keys = sorted(k for k in unet.state_dict() if "_ip." in k)
    want = sorted(f"{tipw.site_module(*s)}.{leaf}" for s in sites for leaf in tipw.IP_LEAVES)
    assert ip_keys == want


def test_install_ip_adapter_errors_and_the_nested_bin(tmp_path):
    """A site without an entry and an entry without a site raise KeyError in
    both packages; a shape mismatch raises ValueError; a nested
    tencent-ailab ``.bin`` is refused by name (ROADMAP C.13), where the JAX
    reader drops its groups and fails on ``proj.weight``."""
    import dataclasses

    cfg = UNetConfig.tiny()
    state = _ip_state(JaxUNetConfig.tiny(), 24)
    _, sites = tipw.parse_ip_adapter_state(state)
    ucfg = dataclasses.replace(cfg, ip_adapter_tokens=4)
    with torch.device("meta"):
        expected = UNet2DConditionModel(ucfg).state_dict()
    base = {k: v for k, v in expected.items() if "_ip." not in k}
    assert set(tipw.install_ip_adapter(base, expected, ucfg, sites)) == set(expected)
    for broken, err, match in (
            ({k: v for k, v in sites.items() if k != 3}, KeyError, "no entry 3"),
            ({**sites, 99: sites[1]}, KeyError, r"\[99\] have no matching"),
            ({**sites, 1: {k: v[:, :8] for k, v in sites[1].items()}}, ValueError, "shape")):
        with pytest.raises(err, match=match):
            tipw.install_ip_adapter(base, expected, ucfg, broken)
    jtree = random_jax_params(JaxSDModelConfig.tiny(), seed=0)
    jp = JaxPipeline(JaxSDModelConfig.tiny(), params=jtree, compute_dtype=jnp.float32,
                     weights_dtype=jnp.float32)
    for i, key in ((3, "no entry 3"), (99, r"\[99\] have no matching")):
        bad = {k: v for k, v in state.items() if not k.startswith("ip_adapter.3.")}
        if i == 99:
            bad = {**state, "ip_adapter.99.to_k_ip.weight": state["ip_adapter.1.to_k_ip.weight"]}
        with pytest.raises(KeyError, match=key):
            jp.load_ip_adapter(bad)
    nested = {"image_proj": {k[11:]: torch.from_numpy(v) for k, v in state.items()
                             if k.startswith("image_proj.")},
              "ip_adapter": {k[11:]: torch.from_numpy(v) for k, v in state.items()
                             if k.startswith("ip_adapter.")}}
    path = str(tmp_path / "ip-adapter_sd15.bin")
    torch.save(nested, path)
    with pytest.raises(ValueError, match="nested.*C.13"):
        tipw.load_ip_adapter_file(path)
    assert jipw.load_ip_adapter_file(path) == ({}, {})
    with pytest.raises(KeyError, match="proj.weight"):
        jp.load_ip_adapter(path)
    flat = str(tmp_path / "ip-adapter_sd15.safetensors")
    save_file(_t(state), flat)
    proj, got = tipw.load_ip_adapter_file(flat)
    assert sorted(got) == sorted(sites) and torch.equal(proj["proj.weight"],
                                                        torch.from_numpy(state["image_proj.proj.weight"]))


def test_load_image_encoder_dir(tmp_path):
    """A directory written by ``save_image_encoder`` loads through both
    packages' readers to the same weights."""
    jcfg, tree, tcfg, state = _vision()
    d = str(tmp_path / "image_encoder")
    tipw.save_image_encoder(d, tcfg, {**state, "vision_model.embeddings.position_ids":
                                      torch.arange(17)[None]})
    cfg, got = tipw.load_image_encoder(d)
    assert cfg == tcfg and set(got) == set(state)
    assert all(torch.equal(got[k], v) for k, v in state.items())
    jcfg2, jparams = jipw.load_image_encoder(d)
    assert jcfg2 == jcfg
    want = params_from_jax({"image_encoder": jparams})["image_encoder"]
    assert all(torch.equal(want[k], v) for k, v in state.items())


# -- the pipelines ---------------------------------------------------------------------

def _pipelines(jax_cfg, torch_cfg, seed, source, vision=None, embed_dim=24):
    """(JAX pipeline, port pipeline) with the adapter ``source`` attached
    (the vision tower too where given), and the port pipeline without it,
    on the same trees."""
    tree = random_jax_params(jax_cfg, seed)
    jp = JaxPipeline(jax_cfg, params=tree, compute_dtype=jnp.float32, weights_dtype=jnp.float32)
    state = params_from_jax(tree)
    tp = PwwPipeline(torch_cfg, params=state, device="cpu", dtype=torch.float32)
    base = PwwPipeline(torch_cfg, params=state, device="cpu", dtype=torch.float32)
    jenc = tenc = None
    if vision is not None:
        jcfg, vtree, tcfg, vstate = vision
        jenc = (jcv.CLIPVisionEncoder(jcfg), vtree, jcfg)
        tenc = (tcfg, vstate)
    jp.load_ip_adapter(source, image_encoder=jenc, image_embed_dim=embed_dim)
    tp.load_ip_adapter(source, image_encoder=tenc, image_embed_dim=embed_dim)
    return jp, tp, base


@pytest.fixture(scope="module")
def standard():
    """Tiny SD-1.5 with a standard adapter (4 tokens) and the vision tower."""
    vision = _vision()
    return _pipelines(JaxSDModelConfig.tiny(), SDModelConfig.tiny(), 0,
                      _ip_state(JaxUNetConfig.tiny(), vision[0].projection_dim),
                      vision, vision[0].projection_dim)


def _latents_match(jp, tp, **kw):
    kw = {**KWARGS, **kw}
    want = np.asarray(jp.generate(**kw))
    got = tp.generate(**kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    return got


def test_load_ip_adapter_checkpoint_and_generate(standard):
    """Precomputed (1, D) embeddings: the JAX latents, unlike the
    adapter-less pipeline's; scale 0 gives the adapter-less latents bit for
    bit; the installed weights are the checkpoint's."""
    jp, tp, base = standard
    assert tp.config.unet.ip_adapter_tokens == jp.config.unet.ip_adapter_tokens == 4
    emb = np.random.default_rng(1).standard_normal((1, 24)).astype(np.float32)
    got = _latents_match(jp, tp, ip_adapter_image=emb)
    plain = base.generate(**KWARGS)
    assert not np.allclose(got, plain)
    np.testing.assert_array_equal(tp.generate(**KWARGS, ip_adapter_image=emb,
                                              ip_adapter_scale=0.0), plain)
    want = params_from_jax({"unet": jp.params["unet"]})["unet"]
    ip = {k: v for k, v in tp.unet.state_dict().items() if "_ip." in k}
    assert len(ip) == 8 and all(torch.equal(want[k], v) for k, v in ip.items())


@pytest.mark.parametrize("route", ["raw image", "PIL image", "no image", "scale 0.5",
                                   "split CFG", "SAG", "DeepCache", "num_samples 2"])
def test_ip_adapter_routes_match_jax(standard, route):
    """A raw image through the vision tower, on every route that carries
    the tokens: the batched call, each CFG half on the split path (a custom
    weight function), the uncond rows of SAG's degraded pass, both DeepCache
    passes."""
    from PIL import Image

    jp, tp, _ = standard
    kw = dict(ip_adapter_image=IMAGE)
    if route == "PIL image":
        kw = dict(ip_adapter_image=Image.fromarray(IMAGE))
    elif route == "no image":
        kw = {}
    elif route == "scale 0.5":
        kw["ip_adapter_scale"] = 0.5
    elif route == "SAG":
        kw["sag_scale"] = 0.75
    elif route == "DeepCache":
        kw.update(cache_interval=2, num_inference_steps=4)
    elif route == "num_samples 2":
        kw["num_samples"] = 2
    if route == "split CFG":
        jkw = dict(kw, weight_function=lambda w, s, qk: 0.4 * w * jnp.log1p(s) * jnp.max(qk))
        kw["weight_function"] = lambda w, s, qk: 0.4 * w * torch.log1p(s) * torch.amax(qk)
        want = np.asarray(jp.generate(**{**KWARGS, **jkw}))
        got = tp.generate(**KWARGS, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    else:
        _latents_match(jp, tp, **kw)


def test_generate_batch_with_one_reference_image_matches_jax(standard):
    """Two requests sharing one reference image, against the JAX
    ``generate_batch``; rows differ."""
    jp, tp, _ = standard
    reqs = [dict(prompt="a cat and a dog", color_map_image=color_map(64), seed=0,
                 color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,0.5"}),
            dict(prompt="a dog and a cat", color_map_image=np.roll(color_map(64), 16, axis=1),
                 seed=1, color_context={(255, 0, 0): "dog,1.0", (0, 0, 255): "cat,0.5"})]
    want = np.asarray(jp.generate_batch(reqs, num_inference_steps=2, noise_mode="torch",
                                        output_type="np", ip_adapter_image=IMAGE))
    got = tp.generate_batch(reqs, num_inference_steps=2, noise_mode="torch",
                            output_type="np", ip_adapter_image=IMAGE)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == (2, 64, 64, 3) and diff.max() <= 1 and (diff > 0).mean() < 2e-2
    assert not np.array_equal(got[0], got[1])


def test_ip_adapter_rejects_image_without_adapter_or_encoder(standard):
    """An image without an adapter, and a raw image without an encoder,
    raise ValueError as in JAX; a raw (H, W, 3) float image goes through
    the encoder, not the precomputed route."""
    _, tp, base = standard
    with pytest.raises(ValueError, match="load_ip_adapter"):
        base.generate(**KWARGS, ip_adapter_image=IMAGE)
    enc = tp._ip["image_encoder"]
    tp._ip["image_encoder"] = None
    try:
        with pytest.raises(ValueError, match="no image encoder attached"):
            tp.generate(**KWARGS, ip_adapter_image=IMAGE)
    finally:
        tp._ip["image_encoder"] = enc
    a = tp.generate(**KWARGS, ip_adapter_image=IMAGE.astype(np.float32) / 255.0)
    b = tp.generate(**KWARGS, ip_adapter_image=IMAGE)
    np.testing.assert_array_equal(a, b)


def test_ip_adapter_plus_pipeline_end_to_end():
    """The plus adapter (a Resampler over the penultimate states, the zero
    image through the encoder for the uncond rows), a raw image and the
    precomputed (1, L, D) states, against JAX."""
    vision = _vision(seed=4)
    jcfg = JaxSDModelConfig.tiny()
    proj = _plus_proj(vision[0].hidden_size, jcfg.unet.cross_attention_dim)
    jp, tp, _ = _pipelines(jcfg, SDModelConfig.tiny(), 1,
                           _ip_state(jcfg.unet, 0, plus=proj), vision)
    assert tp._ip["plus"] and tp.config.unet.ip_adapter_tokens == 6
    _latents_match(jp, tp, ip_adapter_image=IMAGE)
    feats = np.random.default_rng(6).standard_normal((1, 17, 32)).astype(np.float32)
    _latents_match(jp, tp, ip_adapter_image=feats)


def test_ip_adapter_on_sdxl_family():
    """Tiny SDXL: 8 sites at depth 2, precomputed embeddings, against JAX."""
    jcfg = JaxSDModelConfig.tiny_xl()
    jp, tp, base = _pipelines(jcfg, SDModelConfig.tiny_xl(), 2, _ip_state(jcfg.unet, 12), None, 12)
    emb = np.random.default_rng(4).standard_normal((1, 12)).astype(np.float32)
    got = _latents_match(jp, tp, ip_adapter_image=emb)
    assert not np.allclose(got, base.generate(**KWARGS))


def test_a_second_load_replaces_the_adapter():
    """A second ``load_ip_adapter`` installs its own ``to_k_ip``/``to_v_ip``
    (the JAX one keeps the first adapter's, ROADMAP C.17)."""
    jcfg = JaxSDModelConfig.tiny()
    first, second = _ip_state(jcfg.unet, 24, seed=0), _ip_state(jcfg.unet, 24, seed=9)
    jp, tp, base = _pipelines(jcfg, SDModelConfig.tiny(), 0, first)
    jk = jp.params["unet"]["params"]["down_0_attn_0"]["blocks_0"]["attn2"]["to_k_ip"]["kernel"]
    jp.load_ip_adapter(second, image_embed_dim=24)
    tp.load_ip_adapter(second, image_embed_dim=24)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k_ip.weight"
    assert torch.equal(tp.unet.state_dict()[key],
                       torch.from_numpy(second["ip_adapter.1.to_k_ip.weight"]))
    jk2 = jp.params["unet"]["params"]["down_0_attn_0"]["blocks_0"]["attn2"]["to_k_ip"]["kernel"]
    np.testing.assert_array_equal(np.asarray(jk2), np.asarray(jk))
    assert set(tp.unet.state_dict()) == set(UNet2DConditionModel(tp.config.unet).state_dict())


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_server_answers_200_with_generates_image(standard):
    """POST /generate with ``ip_adapter_image_png_b64`` runs alone through
    the Batcher and answers 200 with ``generate``'s image, bit for bit."""
    from PIL import Image

    from pww_tpu_torch.serving.batcher import Batcher
    from pww_tpu_torch.serving.server import make_handler, request_from_json

    _, tp, _ = standard
    body = {"prompt": "a cat", "seed": 3, "steps": 2,
            "color_context": {"(255, 0, 0)": "cat,1.0"},
            "color_map_png_b64": _png_b64(color_map(64)),
            "ip_adapter_image_png_b64": _png_b64(IMAGE)}
    b = Batcher(tp, max_batch=4, max_wait_ms=10.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(b))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        r = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/generate",
                                   data=json.dumps(body).encode(),
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        b.close()
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    want = tp.generate(**request_from_json(body), output_type="np")[0]
    np.testing.assert_array_equal(got, want)
