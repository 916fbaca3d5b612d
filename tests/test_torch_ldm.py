"""Single-file LDM checkpoints, LDM-BERT, JAX-written native directories and
``save_pretrained`` in the port against the JAX package (CPU, f32).

* the LDM → diffusers key maps against the JAX ones on every key of the tiny
  and the full SD-1.5 layout (the port's modules on the meta device), and
  ``chip_smoke.ldm_state_dict`` as their inverse;
* ``load_ldm_checkpoint`` on ``.ckpt`` and ``.safetensors`` files the test
  writes (a tiny SD-1.x with EMA shadows, an I64 ``position_ids`` and an I32
  ``model_ema.num_updates``; a tiny SD-2.x with an OpenCLIP tower): state
  dicts bit-equal to ``params_from_jax`` of the JAX loader's (the JAX
  converter's tables assume two layers a UNet block, so the tiny UNet has
  two, and its family detection knows only the published shapes, so the
  test hands both packages the tiny config);
* ``detect_ldm_config`` across ``global_step`` and ``prediction_type``;
  ``_find_tokenizer``'s outcomes;
* the LDM-BERT tower against ``pww_tpu.models.ldm_bert`` within
  1e-5·max|want|, its refusal and ``--text_encoder_only``;
* a JAX ``save_pretrained`` directory in f32 and in bf16 (ext records and
  chunked arrays), and the JAX converter CLI's output, read by the port;
* the port's ``save_pretrained`` read by the JAX ``from_pretrained``.
"""
import dataclasses
import json
import os
import sys
import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

import chip_smoke
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.ldm_bert import LDMBertEncoder
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu.tokenizer.clip_bpe import synthetic_tokenizer as jax_synthetic_tokenizer
from pww_tpu.weights import ldm_convert as jax_ldm
from pww_tpu.weights import loader as jax_loader
from pww_tpu_torch.config import LDMBertConfig, SDModelConfig
from pww_tpu_torch.models.ldm_bert import LDMBertModel
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.tokenizer.clip_bpe import save_tokenizer_assets, synthetic_tokenizer
from pww_tpu_torch.weights import ldm_convert, loader, safetensors_io
from pww_tpu_torch.weights.bridge import build_models, params_from_jax
from test_ldm_bert import _synth_state
from torch_port_cases import random_jax_params, few_torch_threads  # noqa: F401


def configs(family="sd1"):
    """(JAX config, port config): the tiny one with two layers a UNet block;
    "sd2": per-block head dims, v-prediction and a GELU (OpenCLIP) tower."""
    out = []
    for cfg in (JaxSDModelConfig.tiny(), SDModelConfig.tiny()):
        unet = dataclasses.replace(cfg.unet, layers_per_block=2)
        clip = cfg.clip
        if family == "sd2":
            unet = dataclasses.replace(unet, attention_head_dim=8,
                                       prediction_type="v_prediction")
            clip = dataclasses.replace(clip, hidden_act="gelu")
        out.append(dataclasses.replace(cfg, unet=unet, clip=clip))
    return tuple(out)


def assert_same_fields(cfg, jcfg):
    """The fields the port's configs share with the JAX ones are equal."""
    for part in ("clip", "unet", "vae", "scheduler"):
        mine, ref = getattr(cfg, part), getattr(jcfg, part)
        for f in dataclasses.fields(mine):
            if hasattr(ref, f.name):
                assert getattr(mine, f.name) == getattr(ref, f.name), f"{part}.{f.name}"
    assert cfg.xl_refiner == jcfg.xl_refiner and (cfg.clip2 is None) == (jcfg.clip2 is None)


def assert_states_equal(got, want, parts=("unet", "clip", "vae")):
    for part in parts:
        assert set(got[part]) == set(want[part]), (part, set(got[part]) ^ set(want[part]))
        for k, t in got[part].items():
            np.testing.assert_array_equal(t.float().numpy(), want[part][k].float().numpy(),
                                          err_msg=f"{part}.{k}")


def as_f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


# -- the key maps -------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "sd15"])
def test_key_maps_match_jax_and_ldm_state_dict_inverts_them(name):
    cfg = SDModelConfig.tiny() if name == "tiny" else SDModelConfig.sd15()
    lpb, nb = cfg.unet.layers_per_block, len(cfg.vae.block_out_channels)
    modules = build_models(cfg)  # on the meta device
    params = {part: m.state_dict() for part, m in modules.items()}
    ldm = chip_smoke.ldm_state_dict(cfg, params)
    n_unet = n_vae = 0
    for k in ldm:
        if k.startswith(ldm_convert.UNET_PREFIX):
            key = k[len(ldm_convert.UNET_PREFIX):]
            assert ldm_convert._map_unet_key(key, lpb) == jax_ldm._map_unet_key(key, lpb), k
            n_unet += 1
        elif k.startswith(ldm_convert.VAE_PREFIX):
            key = k[len(ldm_convert.VAE_PREFIX):]
            assert ldm_convert._map_vae_key(key, nb) == jax_ldm._map_vae_key(key, nb), k
            n_vae += 1
    assert n_unet == len(params["unet"]) and n_vae == len(params["vae"])
    unet, vae, clip = ldm_convert.convert_ldm_state_dict(ldm, layers_per_block=lpb,
                                                         vae_blocks=nb)
    for part, sd in (("unet", unet), ("vae", vae), ("clip", clip)):
        back = loader.convert_state_dict(part, sd, params[part])
        back.pop("text_model.embeddings.position_ids", None)
        assert set(back) == set(params[part]), part
        for k, t in back.items():
            assert t.shape == params[part][k].shape, k
    assert ldm["cond_stage_model.transformer.text_model.embeddings.position_ids"].dtype == \
        torch.int64


def test_ldm_state_dict_round_trip_is_the_identity():
    cfg = SDModelConfig.tiny()
    params = params_from_jax(random_jax_params(JaxSDModelConfig.tiny(), seed=4))
    unet, vae, clip = ldm_convert.convert_ldm_state_dict(
        chip_smoke.ldm_state_dict(cfg, params), layers_per_block=1, vae_blocks=4)
    models = build_models(cfg)
    back = {part: {k: v for k, v in loader.convert_state_dict(
        part, sd, models[part].state_dict()).items() if not k.endswith("position_ids")}
        for part, sd in (("unet", unet), ("vae", vae), ("clip", clip))}
    assert_states_equal(back, params)


# -- single files ---------------------------------------------------------------

def open_clip_state(clip_sd, extra_layer):
    """A transformers CLIP state → OpenCLIP's (``cond_stage_model.model.*``
    stripped): q/k/v fused into ``in_proj``, plus a last layer, a projection
    and ``logit_scale`` that SD-2 does not use."""
    out = {"token_embedding.weight": clip_sd["text_model.embeddings.token_embedding.weight"],
           "positional_embedding": clip_sd["text_model.embeddings.position_embedding.weight"],
           "ln_final.weight": clip_sd["text_model.final_layer_norm.weight"],
           "ln_final.bias": clip_sd["text_model.final_layer_norm.bias"],
           "text_projection": torch.ones(4, 4), "logit_scale": torch.tensor(4.6)}
    parts = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1",
             "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
    layers = sorted({int(k.split(".")[3]) for k in clip_sd if ".encoder.layers." in k})
    for i in layers + [extra_layer]:
        src = f"text_model.encoder.layers.{min(i, layers[-1])}."
        rb = f"transformer.resblocks.{i}."
        for leaf in ("weight", "bias"):
            out[rb + f"attn.in_proj_{leaf}"] = torch.cat(
                [clip_sd[src + f"self_attn.{p}_proj.{leaf}"] for p in "qkv"])
            for hf, oc in parts.items():
                out[rb + f"{oc}.{leaf}"] = clip_sd[src + f"{hf}.{leaf}"].clone()
    return out


def write_ldm_file(path, family, tree):
    """A tiny LDM single file from a JAX tree: SD-1.x with ``model_ema.*``
    shadows (the UNet's weights + 1), ``model_ema.decay`` (F32),
    ``model_ema.num_updates`` (I32) and I64 ``position_ids``; SD-2.x with an
    OpenCLIP tower and Linear ``proj_in``/``proj_out``. ``.ckpt`` files hold
    ``{"state_dict", "global_step"}``; ``.safetensors`` ones are written by
    the ``safetensors`` package."""
    cfg = configs(family)[1]
    params = params_from_jax(tree)
    ldm = chip_smoke.ldm_state_dict(cfg, params)
    if family == "sd2":
        ldm = {k: v for k, v in ldm.items() if not k.startswith(ldm_convert.CLIP_PREFIX)}
        for k, v in open_clip_state(params["clip"], cfg.clip.num_layers).items():
            ldm[ldm_convert.OPEN_CLIP_PREFIX + k] = v
        for k in list(ldm):
            if k.startswith(ldm_convert.UNET_PREFIX) and \
                    k.endswith(("proj_in.weight", "proj_out.weight")):
                ldm[k] = ldm[k][:, :, 0, 0].contiguous()
    else:
        for k in list(ldm):
            if k.startswith(ldm_convert.UNET_PREFIX):
                ldm["model_ema." + k[len("model."):].replace(".", "")] = ldm[k] + 1.0
        ldm["model_ema.decay"] = torch.tensor(0.9999)
        ldm["model_ema.num_updates"] = torch.tensor(1234, dtype=torch.int32)
    ldm = {k: v.contiguous() for k, v in ldm.items()}
    if path.endswith(".ckpt"):
        torch.save({"state_dict": ldm, "global_step": 470000}, path)
    else:
        safetensors.torch.save_file(ldm, path)


FILES = [("sd1", ".safetensors"), ("sd1", ".ckpt"), ("sd2", ".safetensors")]


@pytest.fixture(scope="module")
def ldm_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm")
    trees = {f: random_jax_params(configs(f)[0], seed=i) for i, f in enumerate(("sd1", "sd2"))}
    out = {}
    for family, ext in FILES:
        d = root / f"{family}{ext.replace('.', '_')}"
        d.mkdir()
        out[(family, ext)] = path = str(d / f"model{ext}")
        write_ldm_file(path, family, trees[family])
    return out, trees


@pytest.mark.parametrize("family,ext", FILES)
@pytest.mark.parametrize("extract_ema", [True, False])
def test_single_files_load_as_in_the_jax_package(ldm_files, monkeypatch, family, ext,
                                                 extract_ema):
    files, trees = ldm_files
    path = files[(family, ext)]
    jcfg, cfg = configs(family)
    monkeypatch.setattr(jax_ldm, "detect_ldm_config", lambda meta, sd, pt="auto": jcfg)
    with pytest.warns(UserWarning, match="toy tokenizer"):
        _, jparams, jtok = jax_ldm.load_ldm_checkpoint(path, extract_ema=extract_ema)
    with pytest.warns(UserWarning, match="toy tokenizer"):
        got_cfg, params, tok = ldm_convert.load_ldm_checkpoint(path, extract_ema=extract_ema,
                                                               config=cfg)
    assert got_cfg == cfg
    want = params_from_jax(as_f32(jparams))
    assert_states_equal(params, want)
    source = params_from_jax(trees[family])
    ema = extract_ema and family == "sd1"
    for k, t in params["unet"].items():  # the EMA shadows are the weights + 1
        np.testing.assert_array_equal(t.numpy(), source["unet"][k].numpy() + (1.0 if ema else 0))
    assert tok("a cat and a dog") == jtok("a cat and a dog")


def test_a_safetensors_file_with_integer_tensors_loads_through_the_dispatch(ldm_files,
                                                                           monkeypatch):
    """The package-written SD-1.x file holds I64 ``position_ids`` and I32
    ``model_ema.num_updates``: both loaders' ``load_pipeline_checkpoint``
    take it (the families detected as the tiny config)."""
    files, _ = ldm_files
    path = files[("sd1", ".safetensors")]
    header = safetensors_io.load_file(path)
    assert header["model_ema.num_updates"].dtype == torch.int32
    assert header["cond_stage_model.transformer.text_model.embeddings.position_ids"].dtype \
        == torch.int64
    jcfg, cfg = configs("sd1")
    monkeypatch.setattr(jax_ldm, "detect_ldm_config", lambda meta, sd, pt="auto": jcfg)
    monkeypatch.setattr(ldm_convert, "detect_ldm_config", lambda meta, sd, pt="auto": cfg)
    with pytest.warns(UserWarning, match="toy tokenizer"):
        _, jparams, _, jtok2 = jax_loader.load_pipeline_checkpoint(path)
    with pytest.warns(UserWarning, match="toy tokenizer"):
        got_cfg, params, _, tok2 = loader.load_pipeline_checkpoint(path)
    assert got_cfg == cfg and tok2 is None and jtok2 is None
    assert_states_equal(params, params_from_jax(as_f32(jparams)))
    assert loader.recorded_scheduler(path) == "lms"


def test_detect_ldm_config_matches_jax():
    def unet_sd(ctx, in_channels=4):
        return {"conv_in.weight": torch.zeros(320, in_channels, 3, 3),
                "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight":
                    torch.zeros(320, ctx)}

    cases = [({}, 768, 4, "auto"), ({}, 768, 9, "auto"), ({}, 768, 4, "v_prediction"),
             ({"global_step": 220000}, 1024, 4, "auto"),
             ({"global_step": 110000}, 1024, 4, "auto"), ({}, 1024, 9, "auto"),
             ({"global_step": 5}, 1024, 4, "epsilon"), ({}, 1024, 4, "v_prediction")]
    for meta, ctx, cin, pt in cases:
        sd = unet_sd(ctx, cin)
        with warnings.catch_warnings(record=True) as mine:
            warnings.simplefilter("always")
            cfg = ldm_convert.detect_ldm_config(meta, sd, pt)
        with warnings.catch_warnings(record=True) as theirs:
            warnings.simplefilter("always")
            jcfg = jax_ldm.detect_ldm_config(meta, {k: v.numpy() for k, v in sd.items()}, pt)
        assert_same_fields(cfg, jcfg)
        assert [str(w.message) for w in mine] == [str(w.message) for w in theirs]
        assert bool(mine) == (ctx == 1024 and pt == "auto" and "global_step" not in meta)
    assert ldm_convert.detect_ldm_config({}, unet_sd(768)) == SDModelConfig.sd15()
    assert ldm_convert.detect_ldm_config({"global_step": 110000}, unet_sd(1024)) == \
        SDModelConfig.sd21()


def test_find_tokenizer_outcomes_match_jax(tmp_path):
    import gzip

    ckpt = tmp_path / "beside" / "model.safetensors"
    ckpt.parent.mkdir()
    explicit = tmp_path / "explicit"
    save_tokenizer_assets(synthetic_tokenizer(1000), str(explicit))
    text = "a cat and a dog, realistic photo"
    # 1. real files: an explicit directory, the checkpoint's own, a .txt.gz beside it
    got = ldm_convert._find_tokenizer(str(ckpt), str(explicit))
    assert got(text) == jax_ldm._find_tokenizer(str(ckpt), str(explicit))(text)
    save_tokenizer_assets(synthetic_tokenizer(1000), str(ckpt.parent / "tokenizer"))
    assert ldm_convert._find_tokenizer(str(ckpt), None)(text) == \
        jax_ldm._find_tokenizer(str(ckpt), None)(text)
    gz_dir = tmp_path / "gz"
    gz_dir.mkdir()
    with gzip.open(gz_dir / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(["c a", "d o", "ca t</w>", "do g</w>"]))
    gz_ckpt = str(gz_dir / "model.ckpt")
    mine, theirs = (m._find_tokenizer(gz_ckpt, None) for m in (ldm_convert, jax_ldm))
    assert mine("a cat and a dog") == theirs("a cat and a dog")
    assert len(mine.encoder) == len(theirs.encoder) == 512 + 4 + 2
    # 2. nothing found: a loud warning and the caller's toy fallback
    bare = str(tmp_path / "bare" / "model.ckpt")
    os.makedirs(os.path.dirname(bare))
    for m in (ldm_convert, jax_ldm):
        with pytest.warns(UserWarning, match="toy tokenizer"):
            assert m._find_tokenizer(bare, None) is None
    # 3. an explicit path without files raises
    for m in (ldm_convert, jax_ldm):
        with pytest.raises(FileNotFoundError, match="no tokenizer assets"):
            m._find_tokenizer(bare, str(tmp_path / "bare"))


# -- LDM-BERT -------------------------------------------------------------------

def test_ldm_bert_matches_jax():
    from pww_tpu.config import LDMBertConfig as JaxLDMBertConfig

    sd = _synth_state(JaxLDMBertConfig.tiny(), seed=3)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    # the head split no shape fixes: the default guess, then the tiny config's
    assert dataclasses.asdict(ldm_convert.convert_ldm_bert(tsd)[0]) == \
        dataclasses.asdict(jax_ldm.convert_ldm_bert(sd)[0])
    jcfg, jparams = jax_ldm.convert_ldm_bert(sd, num_heads=2)
    cfg, state = ldm_convert.convert_ldm_bert(tsd, num_heads=2)
    assert cfg == LDMBertConfig.tiny() and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, cfg.max_position_embeddings))
    want_h, want_logits = LDMBertEncoder(jcfg).apply(jparams, jnp.asarray(ids),
                                                     return_logits=True)
    with torch.device("meta"):
        model = LDMBertModel(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    with torch.inference_mode():
        got_h, got_logits = model(torch.from_numpy(ids), return_logits=True)
    for got, want in ((got_h, want_h), (got_logits, want_logits)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert len(state) == len(jax.tree.leaves(jparams)) == len(sd)
    for k in state:  # every tensor came from its LDM key, unchanged
        assert torch.equal(state[k], torch.from_numpy(sd[ldm_convert.ldm_bert_key(k)]))


def test_ldm_bert_bf16_rounding_matches_jax():
    """The tower in bf16 against itself in f32, in both packages, on the
    same weights: the port's relative L2 error within 1.5× the JAX
    package's (its bf16 forward keeps the residual stream in bf16, as the
    port's does), and the two bf16 outputs closer to each other than to
    f32. ``chip_smoke.py`` holds the card's bf16 tower against the CPU's f32
    one at the published size."""
    from pww_tpu.config import LDMBertConfig as JaxLDMBertConfig

    cfg = JaxLDMBertConfig(vocab_size=300, d_model=256, num_layers=4, num_heads=4,
                           head_dim=64, ffn_dim=1024, max_position_embeddings=77)
    sd = _synth_state(cfg, seed=2)
    jcfg, jparams = jax_ldm.convert_ldm_bert(sd)
    conf, state = ldm_convert.convert_ldm_bert({k: torch.from_numpy(v) for k, v in sd.items()})
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 77))
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.device("meta"):
            model = LDMBertModel(conf)
        model.load_state_dict({k: v.to(dtype) for k, v in state.items()}, assign=True)
        with torch.inference_mode():
            outs[dtype] = model(torch.from_numpy(ids)).float().numpy()
    want = np.asarray(LDMBertEncoder(jcfg).apply(jparams, jnp.asarray(ids)))
    jb = np.asarray(LDMBertEncoder(jcfg, dtype=jnp.bfloat16).apply(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams), jnp.asarray(ids)),
        np.float32)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    mine, theirs = rel(outs[torch.bfloat16], want), rel(jb, want)
    assert rel(outs[torch.float32], want) < 1e-5
    assert 1e-3 < mine <= 1.5 * theirs, (mine, theirs)
    assert rel(outs[torch.bfloat16], jb) < mine


@pytest.fixture(scope="module")
def bert_file(tmp_path_factory):
    from pww_tpu.config import LDMBertConfig as JaxLDMBertConfig

    sd = _synth_state(JaxLDMBertConfig.tiny(), seed=1)
    path = str(tmp_path_factory.mktemp("bert") / "txt2img-1p4B.ckpt")
    torch.save({"state_dict": {ldm_convert.CLIP_PREFIX + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return path, sd


def test_ldm_bert_checkpoints_are_refused_as_in_jax(bert_file):
    path, _ = bert_file
    with pytest.raises(ValueError, match="LDM-BERT") as mine:
        ldm_convert.load_ldm_checkpoint(path)
    with pytest.raises(ValueError, match="LDM-BERT") as theirs:
        jax_ldm.load_ldm_checkpoint(path)
    assert str(mine.value) == str(theirs.value).replace("pww_tpu.", "pww_tpu_torch.")


def test_text_encoder_only_cli(bert_file, ldm_files, tmp_path, capsys):
    path, sd = bert_file
    out = str(tmp_path / "bert")
    assert ldm_convert.main(["--checkpoint_path", path, "--dump_path", out,
                             "--text_encoder_only"]) == 0
    with open(os.path.join(out, "config.json")) as f:
        meta = json.load(f)
    jcfg, _ = jax_ldm.convert_ldm_bert(sd)
    assert meta == {"ldm_bert": dataclasses.asdict(jcfg), "source": "txt2img-1p4B.ckpt"}
    state = safetensors_io.load_file(os.path.join(out, "ldm_bert.safetensors"))
    _, want = ldm_convert.convert_ldm_bert({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
    with pytest.raises(SystemExit) as e:  # an SD checkpoint has no LDM-BERT tower
        ldm_convert.main(["--checkpoint_path", ldm_files[0][("sd1", ".ckpt")],
                          "--dump_path", str(tmp_path / "x"), "--text_encoder_only"])
    assert e.value.code == 2 and "CLIP tower" in capsys.readouterr().err


# -- native directories and save_pretrained ---------------------------------------

@pytest.fixture(scope="module")
def jax_tree():
    return random_jax_params(JaxSDModelConfig.tiny(), seed=6)


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_jax_written_directories_load(jax_tree, tmp_path, monkeypatch, weights):
    """The JAX ``save_pretrained``: ``params.msgpack`` (bf16: ext records of
    dtype "bfloat16", with flax's chunk size cut to 4 KiB so that the larger
    arrays are written as chunked records), ``config.json`` with the JAX
    configs' TPU fields, and the tokenizer's files."""
    jcfg = JaxSDModelConfig.tiny()
    jp = JaxPipeline(jcfg, params=jax_tree, tokenizer=jax_synthetic_tokenizer(1000),
                     scheduler="ddim", compute_dtype=jnp.float32,
                     weights_dtype=jnp.float32 if weights == "f32" else jnp.bfloat16)
    path = str(tmp_path / "native")
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    jp.save_pretrained(path)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        raw = f.read()
    assert b"__msgpack_chunked_array__" in raw and (b"bfloat16" in raw) == (weights == "bf16")
    cfg, params, tok, tok2 = loader.load_pipeline_checkpoint(path)
    assert_same_fields(cfg, jcfg)
    assert cfg == SDModelConfig.tiny() and tok2 is None
    assert all(t.dtype == (torch.float32 if weights == "f32" else torch.bfloat16)
               for sd in params.values() for t in sd.values())
    assert_states_equal(params, params_from_jax(as_f32(jp.params)))
    assert tok("a cat and a dog") == jp.tokenizer("a cat and a dog")
    assert PwwPipeline.from_pretrained(path, device="cpu").scheduler.kind == "ddim"


def test_the_jax_converter_clis_output_loads(ldm_files, tmp_path, monkeypatch):
    files, _ = ldm_files
    path = files[("sd1", ".ckpt")]
    save_tokenizer_assets(synthetic_tokenizer(1000), os.path.dirname(path))
    jcfg, cfg = configs("sd1")
    monkeypatch.setattr(jax_ldm, "detect_ldm_config", lambda meta, sd, pt="auto": jcfg)
    out = str(tmp_path / "converted")
    monkeypatch.setattr(sys, "argv", ["ldm_convert", "--checkpoint_path", path, "--dump_path",
                                      out, "--extract_ema", "--scheduler_type", "euler"])
    jax_ldm._cli()
    got_cfg, params, tok, _ = loader.load_pipeline_checkpoint(out)
    want_cfg, want, want_tok = ldm_convert.load_ldm_checkpoint(path, extract_ema=True,
                                                               config=cfg)
    assert got_cfg == want_cfg == cfg
    assert_states_equal(params, want)
    assert tok("a cat and a dog") == want_tok("a cat and a dog")
    assert loader.recorded_scheduler(out) == "euler"


def test_native_config_drops_tpu_fields_and_refuses_settings_it_would_lose():
    meta = {"model": dataclasses.asdict(JaxSDModelConfig.tiny())}
    assert meta["model"]["unet"]["xattn_variant"] == "fused"
    assert loader.native_config(meta) == SDModelConfig.tiny()
    for field, value, err, match in (("tome_ratio", 0.5, NotImplementedError, "tome_ratio="),
                                     ("freeu", [1.5, 1.6, 0.9, 0.2], NotImplementedError,
                                      "freeu="),
                                     ("new_knob", 1, ValueError, "unknown unet config field")):
        bad = json.loads(json.dumps(meta))
        bad["model"]["unet"][field] = value
        with pytest.raises(err, match=match):
            loader.native_config(bad)


@pytest.mark.parametrize("family", ["sd1", "xl"])
def test_save_pretrained_round_trips(jax_tree, tmp_path, family):
    """The port's ``save_pretrained``: its own ``from_pretrained`` reads the
    weights back bit-equal with the scheduler; for SD-1.x the JAX
    ``from_pretrained`` too, by its diffusers branch."""
    if family == "xl":
        cfg = SDModelConfig.tiny_xl()
        tp = PwwPipeline(cfg, tokenizer=synthetic_tokenizer(1000), scheduler="euler",
                         device="cpu", dtype=torch.float32, seed=3)
    else:
        cfg = SDModelConfig.tiny()
        tp = PwwPipeline(cfg, params=params_from_jax(jax_tree),
                         tokenizer=synthetic_tokenizer(1000), scheduler="euler",
                         device="cpu", dtype=torch.float32)
    path = str(tmp_path / "saved")
    tp.save_pretrained(path)
    assert not os.path.exists(os.path.join(path, "params.msgpack"))
    parts = {"unet": tp.unet, "clip": tp.clip, "vae": tp.vae}
    if tp.clip2 is not None:
        parts["clip2"] = tp.clip2
    mine = {part: m.state_dict() for part, m in parts.items()}
    back = PwwPipeline.from_pretrained(path, device="cpu", dtype=torch.float32)
    assert back.config == cfg and back.scheduler.kind == "euler"
    assert_states_equal({part: getattr(back, part).state_dict() for part in parts}, mine,
                        tuple(parts))
    text = "a cat and a dog"
    assert back.tokenizer(text) == tp.tokenizer(text)
    if family == "xl":
        assert back.tokenizer_2(text) == tp.tokenizer_2(text)
        return
    jp = JaxPipeline.from_pretrained(path, compute_dtype=jnp.float32,
                                     weights_dtype=jnp.float32)
    assert jp.scheduler.kind == "euler"
    assert_states_equal(params_from_jax(as_f32(jp.params)), mine)
    assert jp.tokenizer(text) == tp.tokenizer(text)
