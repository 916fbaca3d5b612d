"""The port's checkpoint loading against the JAX package's (CPU).

* ``weights/safetensors_io`` against the ``safetensors`` package, both ways,
  the integer types included;
* the port's ``load_pipeline_checkpoint`` and the JAX one on the same tiny
  diffusers directories (SD-1.x, 9-channel inpainting, and SD-2-style with
  per-block head counts, Linear ``proj_in``/``proj_out`` and the old VAE
  attention names; ``.safetensors`` and ``.bin``): the configs field by
  field, the tokenizers, and every weight exactly through ``params_from_jax``;
* ``pww_load_tools`` / ``paint_with_words(local_model_path=...)`` against the
  JAX pipeline loaded from the same directory, ``generate(noise_mode=
  "torch")``, within the txt2img test's tolerance.
"""
import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu.weights import loader as jax_loader
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.pipeline import facade
from pww_tpu_torch.pipeline.facade import paint_with_words, pww_load_tools
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.tokenizer.clip_bpe import synthetic_tokenizer
from pww_tpu_torch.weights import loader, safetensors_io
from pww_tpu_torch.weights.bridge import params_from_jax
from torch_port_cases import color_map, random_jax_params, few_torch_threads  # noqa: F401

OLD_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


# -- safetensors ---------------------------------------------------------------

def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    return {"a.weight": torch.randn((3, 5), generator=g).to(dtype),
            "b": torch.randn((2, 1, 4, 4), generator=g).to(dtype),
            "scalar": torch.tensor(1.5).to(dtype),
            "odd": torch.randn((7,), generator=g).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_safetensors_round_trips_against_the_package(tmp_path, dtype):
    ts = _tensors(dtype)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(ts, ours)
    back = safetensors.numpy.load_file(ours)
    assert set(back) == set(ts)
    for k, t in ts.items():
        assert back[k].dtype == t.numpy().dtype
        np.testing.assert_array_equal(back[k], t.numpy())
    safetensors.numpy.save_file({k: t.numpy() for k, t in ts.items()}, theirs,
                                metadata={"format": "pt"})  # skipped by the reader
    back = safetensors_io.load_file(theirs)
    assert set(back) == set(ts)
    for k, t in back.items():
        assert t.dtype == dtype
        torch.testing.assert_close(t, ts[k], rtol=0, atol=0)


def test_safetensors_bf16_round_trips_against_the_package(tmp_path):
    ts = _tensors(torch.bfloat16)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(ts, ours)
    for k, t in safetensors.torch.load_file(ours).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, ts[k])
    safetensors.torch.save_file(ts, theirs)
    for k, t in safetensors_io.load_file(theirs).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, ts[k])


def test_safetensors_refuses_other_types_and_bad_offsets(tmp_path):
    """The integer and bool types real single files hold (I64 ``position_ids``,
    I32 ``model_ema.num_updates``) read as ``safetensors.numpy`` reads them
    and round-trip; a dtype name the format does not define, a type the
    reader lacks (F64) and offsets that do not fit are refused."""
    import json

    p = str(tmp_path / "x.safetensors")
    rng = np.random.default_rng(0)
    ints = {"position_ids": np.arange(77, dtype=np.int64)[None],
            "num_updates": np.array(1234, np.int32),
            "i16": rng.integers(-300, 300, (3, 4)).astype(np.int16),
            "i8": rng.integers(-100, 100, (5,)).astype(np.int8),
            "u8": rng.integers(0, 255, (2, 3)).astype(np.uint8),
            "mask": rng.random((4,)) > 0.5}
    safetensors.numpy.save_file(ints, p)
    back = safetensors_io.load_file(p)
    want = safetensors.numpy.load_file(p)
    assert set(back) == set(want) == set(ints)
    for k, t in back.items():
        assert t.numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    safetensors_io.save_file(back, p)
    for k, a in safetensors.numpy.load_file(p).items():
        assert a.dtype == ints[k].dtype
        np.testing.assert_array_equal(a, ints[k], err_msg=k)
    with pytest.raises(ValueError, match="dtype"):
        safetensors_io.save_file({"i": torch.zeros(3, dtype=torch.complex64)}, p)
    for dtype in ("X99", "F64"):
        raw = json.dumps({"i": {"dtype": dtype, "shape": [2], "data_offsets": [0, 4]}}).encode()
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw + bytes(4))
        with pytest.raises(ValueError, match=dtype):
            safetensors_io.load_file(p)
    safetensors_io.save_file({"x": torch.zeros(4)}, p)
    with open(p, "r+b") as f:  # cut the data short
        f.truncate(os.path.getsize(p) - 4)
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(p)


# -- directories ---------------------------------------------------------------

def _configs(family):
    """(JAX config, port config) of one tiny family."""
    if family == "inpaint":
        return JaxSDModelConfig.tiny(in_channels=9), SDModelConfig.tiny(in_channels=9)
    jc, tc = JaxSDModelConfig.tiny(), SDModelConfig.tiny()
    if family == "sd2":  # per-block head counts of head dim 8, v-prediction, GELU CLIP
        def sd2(cfg):
            return dataclasses.replace(
                cfg, clip=dataclasses.replace(cfg.clip, hidden_act="gelu"),
                unet=dataclasses.replace(cfg.unet, attention_head_dim=8,
                                         prediction_type="v_prediction"))
        jc, tc = sd2(jc), sd2(tc)
    return jc, tc


def write_dir(path, family, weights_format, tree):
    """A tiny diffusers directory from a JAX tree; SD-2-style ones with the
    old VAE attention names, ``.bin`` ones with the CLIP's ``position_ids``
    buffer."""
    tc = _configs(family)[1]
    params = params_from_jax(tree)
    if family == "sd2":
        vae = {}
        for k, t in params["vae"].items():
            for new, old in OLD_VAE_NAMES.items():
                k = k.replace(f"mid_block.attentions.0.{new}.", f"mid_block.attentions.0.{old}.")
            vae[k] = t
        params["vae"] = vae
    params["clip"]["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    if weights_format == "safetensors":  # an int64 buffer: the .bin files only
        del params["clip"]["text_model.embeddings.position_ids"]
    loader.save_diffusers_checkpoint(path, tc, params, synthetic_tokenizer(1000),
                                     weights_format=weights_format)


def assert_same_fields(cfg, jcfg):
    """Every field the port's configs share with the JAX ones (the port has
    one dispatch knob of its own, ``fused_cross_min_seq``) is equal."""
    for part in ("clip", "unet", "vae"):
        mine, ref = getattr(cfg, part), getattr(jcfg, part)
        shared = [f.name for f in dataclasses.fields(mine) if hasattr(ref, f.name)]
        assert len(shared) >= len(dataclasses.fields(mine)) - 1
        for name in shared:
            assert getattr(mine, name) == getattr(ref, name), f"{part}.{name}"


DIRS = [("sd1", "safetensors"), ("sd1", "bin"), ("inpaint", "safetensors"),
        ("sd2", "safetensors"), ("sd2", "bin")]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkpoints")
    out, trees = {}, {}
    for family, weights_format in DIRS:
        if family not in trees:
            trees[family] = random_jax_params(_configs(family)[0], seed=len(trees))
        out[(family, weights_format)] = path = str(root / f"{family}-{weights_format}")
        write_dir(path, family, weights_format, trees[family])
    return out


@pytest.mark.parametrize("family,weights_format", DIRS)
def test_loader_matches_the_jax_loader(dirs, family, weights_format):
    path = dirs[(family, weights_format)]
    for sub in ("unet", "text_encoder", "vae"):
        assert loader._find_weights_file(os.path.join(path, sub)).endswith(weights_format)
    jcfg, jparams, jtok, _ = jax_loader.load_pipeline_checkpoint(path)
    cfg, params, tok, tok2 = loader.load_pipeline_checkpoint(path)
    assert tok2 is None
    assert_same_fields(cfg, jcfg)
    written = _configs(family)[1]
    if written.unet.attention_head_dim is not None:  # then the head count is unused;
        # the loaders put the JAX default there
        written = dataclasses.replace(written, unet=dataclasses.replace(
            written.unet, num_attention_heads=8))
    assert cfg == written
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for part in ("unet", "clip", "vae"):
        assert set(params[part]) == set(want[part]), part
        for k, t in params[part].items():
            np.testing.assert_array_equal(t.float().numpy(), want[part][k].numpy(), err_msg=k)
    assert tok.pad_token_id == jtok.pad_token_id
    assert tok("a cat and a dog") == jtok("a cat and a dog")
    if family == "sd2":
        assert params["unet"]["down_blocks.0.attentions.0.proj_in.weight"].shape == (32, 32, 1, 1)
        assert cfg.unet.heads_for(32) == (4, 8)


def test_config_from_checkpoint_reads_sd21_fields(tmp_path):
    import json

    os.makedirs(tmp_path / "unet")
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump({"block_out_channels": [320, 640, 1280, 1280],
                   "attention_head_dim": [5, 10, 20, 20], "sample_size": 96,
                   "prediction_type": "v_prediction", "cross_attention_dim": 1024}, f)
    cfg = loader.config_from_checkpoint(str(tmp_path))
    assert_same_fields(cfg, jax_loader.config_from_checkpoint(str(tmp_path)))
    assert cfg.unet == SDModelConfig.sd21().unet
    assert [cfg.unet.heads_for(c) for c in (320, 640, 1280)] == [(5, 64), (10, 64), (20, 64)]


def test_missing_key_raises_and_position_ids_do_not(dirs, tmp_path):
    cfg, params, _, _ = loader.load_pipeline_checkpoint(dirs[("sd1", "bin")])
    assert "text_model.embeddings.position_ids" not in params["clip"]
    expected = params["unet"]
    state = dict(expected)
    del state["conv_in.weight"], state["mid_block.resnets.0.conv1.bias"]
    with pytest.raises(KeyError, match="2 params missing.*conv_in.weight"):
        loader.convert_state_dict("unet", state, expected)
    with pytest.raises(RuntimeError, match="Unexpected key"):  # strict for the rest
        PwwPipeline(cfg, params={**params, "vae": {**params["vae"], "extra": torch.zeros(1)}},
                    device="cpu", dtype=torch.float32)


def test_unported_formats_raise(tmp_path):
    """Single files and ``params.msgpack`` directories load now
    (tests/test_torch_ldm.py holds them against the JAX loaders). What the
    dispatch still refuses: an original-LDM (LDM-BERT) single file, as the
    reference does, and a JAX-written directory saved with an IP-Adapter
    attached (``ip_adapter_tokens`` set), which the JAX loader cannot run
    either: it raises tracing the UNet without an IpState (ROADMAP C.14);
    a file that is no checkpoint raises where it is read."""
    import json

    bert = tmp_path / "ldm.safetensors"
    safetensors.numpy.save_file(
        {"cond_stage_model.transformer.token_emb.weight": np.zeros((10, 4), np.float32)},
        str(bert))
    with pytest.raises(ValueError, match="LDM-BERT"):
        loader.load_pipeline_checkpoint(str(bert))
    native = tmp_path / "native"
    native.mkdir()
    model = dataclasses.asdict(JaxSDModelConfig.tiny())
    model["unet"]["ip_adapter_tokens"] = 4
    (native / "config.json").write_text(json.dumps({"model": model}))
    (native / "params.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="C.14.*load_ip_adapter"):
        loader.load_pipeline_checkpoint(str(native))
    from pww_tpu.weights.loader import load_pipeline_checkpoint as jax_load

    with pytest.raises(ValueError, match="pass an IpState operand"):
        jax_load(str(native))
    model["unet"]["ip_adapter_tokens"] = None
    (native / "config.json").write_text(json.dumps({"model": model}))
    with pytest.raises(ValueError, match="params.msgpack holds"):  # an empty map
        loader.load_pipeline_checkpoint(str(native))
    f = tmp_path / "model.safetensors"
    f.write_bytes(b"")
    with pytest.raises(struct.error):
        loader.load_pipeline_checkpoint(str(f))


# -- the facade ---------------------------------------------------------------

KWARGS = dict(input_prompt="a cat and a dog", color_map_image=color_map(128),
              color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"},
              num_inference_steps=3, seed=0)


def test_pww_load_tools_matches_the_jax_pipeline(dirs, monkeypatch):
    """``paint_with_words(local_model_path=...)`` on the CPU against the JAX
    pipeline ``from_pretrained`` loads from the same directory (what the JAX
    ``pww_load_tools`` calls), both in f32: final latents within f32
    summation-order noise, as the txt2img test."""
    monkeypatch.setattr(facade, "_PIPELINE_CACHE", {})
    path = dirs[("sd1", "safetensors")]
    jp = JaxPipeline.from_pretrained(path, compute_dtype=jnp.float32,
                                     weights_dtype=jnp.float32)
    want = np.asarray(jp.generate(
        prompt=KWARGS["input_prompt"], color_map_image=KWARGS["color_map_image"],
        color_context=KWARGS["color_context"], num_inference_steps=3, seed=0,
        noise_mode="torch", return_latents=True))
    got = paint_with_words(local_model_path=path, device="cpu", return_latents=True,
                           noise_mode="torch", **KWARGS)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    pipe = pww_load_tools("cpu", local_model_path=path)
    assert pipe is pww_load_tools("cpu", local_model_path=path)  # cached
    assert pipe.dtype == torch.float32 and pipe.scheduler.kind == "lms"
    assert pww_load_tools("cpu", "ddim", local_model_path=path) is not pipe


def test_hub_ids_and_tokens_raise():
    with pytest.raises(FileNotFoundError, match="hub id"):
        pww_load_tools("cpu", hf_model_path="runwayml/stable-diffusion-v1-5")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        paint_with_words(local_model_path="/nonexistent/sd", device="cpu")
    with pytest.raises(NotImplementedError, match="model_token"):
        pww_load_tools("cpu", local_model_path="/nonexistent/sd", model_token="t")
    with pytest.raises(ValueError, match="either"):
        pww_load_tools("cpu")


def test_from_pretrained_takes_the_recorded_scheduler(dirs, tmp_path):
    import json
    import shutil

    path = str(tmp_path / "sd1")
    shutil.copytree(dirs[("sd1", "bin")], path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"scheduler_type": "ddim"}, f)
    assert PwwPipeline.from_pretrained(path, device="cpu").scheduler.kind == "ddim"
    assert PwwPipeline.from_pretrained(path, scheduler="euler",
                                       device="cpu").scheduler.kind == "euler"
