"""Textual inversion and caller-supplied initial noise in the port against
the JAX package (CPU, f32 on both sides).

* ``read_learned_embedding`` / ``load_learned_embed_in_clip`` on files the
  test writes (diffusers ``.bin`` and ``.safetensors``, A1111 ``.pt``; one
  and two vectors): the placeholder string, the tokenizer's ids and the
  embedding table bit-equal to the JAX package's;
* ``apply_textual_inversion`` on both pipelines: re-applying overwrites in
  place, ``vocab_size`` follows the table, the encode caches are dropped;
* a tiny txt2img with the placeholder in the prompt and in a region label,
  and ``generate(latents=...)`` in NHWC, against the JAX pipeline in torch
  noise mode, within the txt2img test's tolerance (2e-5·max|want|);
* ``latents=make_noise(seed)`` gives the ``seed=`` result bit for bit; the
  wrong shape's ``ValueError``; ``rng`` and ``sharding`` name their items.
"""
import numpy as np
import pytest
import safetensors.numpy
import torch

from pww_tpu.weights import textual_inversion as jax_ti
from pww_tpu_torch.conditioning.seeding import make_noise
from pww_tpu_torch.tokenizer.clip_bpe import toy_tokenizer
from pww_tpu_torch.weights import textual_inversion as ti
from pww_tpu_torch.weights.bridge import params_from_jax
from torch_port_cases import (color_map, pipeline_pair, random_jax_params,  # noqa: F401
                              few_torch_threads)
from pww_tpu.config import SDModelConfig as JaxSDModelConfig

HIDDEN = 32  # the tiny text tower's width


def write_embedding(path, fmt, n_vectors, seed=0, token="<cat-toy>"):
    """An embedding file: "diffusers" ({token: vec}, .bin or .safetensors)
    or "a1111" (.pt, ``string_to_param["*"]`` under ``name``); returns the
    (n, HIDDEN) f32 vectors."""
    vecs = np.random.default_rng(seed).standard_normal((n_vectors, HIDDEN)).astype(np.float32)
    stored = vecs if n_vectors > 1 else vecs[0]
    if fmt == "a1111":
        torch.save({"string_to_token": {"*": torch.tensor(265)},
                    "string_to_param": {"*": torch.nn.Parameter(torch.from_numpy(vecs))},
                    "name": token, "step": 10}, path)
    elif path.endswith(".safetensors"):
        safetensors.numpy.save_file({token: stored}, path)
    else:
        torch.save({token: torch.from_numpy(stored)}, path)
    return vecs


FILES = [("diffusers", ".bin", 1), ("diffusers", ".bin", 2), ("diffusers", ".safetensors", 1),
         ("diffusers", ".safetensors", 2), ("a1111", ".pt", 1), ("a1111", ".pt", 2)]


@pytest.fixture(scope="module")
def clip_tree():
    return random_jax_params(JaxSDModelConfig.tiny(), seed=3)["clip"]


@pytest.mark.parametrize("fmt,ext,n", FILES)
def test_embedding_files_load_as_in_the_jax_package(tmp_path, clip_tree, fmt, ext, n):
    path = str(tmp_path / f"emb{ext}")
    vecs = write_embedding(path, fmt, n)
    got, want = ti.read_learned_embedding(path), jax_ti.read_learned_embedding(path)
    assert list(got) == list(want) == ["<cat-toy>"]
    np.testing.assert_array_equal(got["<cat-toy>"].numpy(), np.asarray(want["<cat-toy>"]))

    tok, jtok = toy_tokenizer(1000), toy_tokenizer(1000)
    state = params_from_jax({"clip": clip_tree})["clip"]
    new_state, placeholder = ti.load_learned_embed_in_clip(path, state, tok)
    new_tree, jplaceholder = jax_ti.load_learned_embed_in_clip(path, clip_tree, jtok)
    assert placeholder == jplaceholder == " ".join(
        ["<cat-toy>"] + [f"<cat-toy>_{i}" for i in range(1, n)])
    assert tok.added_tokens == jtok.added_tokens
    assert tok(f"a {placeholder} here") == jtok(f"a {placeholder} here")
    table = new_state[ti.TOKEN_EMBEDDING]
    assert table.shape == (1000 + n, HIDDEN)
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(new_tree["params"]["token_embedding"]["embedding"]))
    np.testing.assert_array_equal(table[1000:].numpy(), vecs)
    assert torch.equal(state[ti.TOKEN_EMBEDDING], table[:1000])  # the input is not changed


def test_wrong_width_raises(tmp_path, clip_tree):
    path = str(tmp_path / "emb.bin")
    torch.save({"<x>": torch.zeros(HIDDEN + 1)}, path)
    state = params_from_jax({"clip": clip_tree})["clip"]
    with pytest.raises(ValueError, match="embedding dim 33 != CLIP hidden 32"):
        ti.load_learned_embed_in_clip(path, state, toy_tokenizer(1000))


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=0)


@pytest.fixture(scope="module")
def embedding(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ti") / "cat-toy.pt")
    write_embedding(path, "a1111", 2, seed=5)
    return path


def test_reapplying_overwrites_in_place(tmp_path):
    """Both pipelines from one set of weights: apply an embedding, then a
    new one under the same placeholder. The rows are overwritten, no row is
    appended, ``config.clip.vocab_size`` and the module follow the table,
    and the port's encode caches are emptied by each apply."""
    jp, tp = pipeline_pair(seed=0)
    first, second = str(tmp_path / "a.safetensors"), str(tmp_path / "b.bin")
    write_embedding(first, "diffusers", 2, seed=1, token="<style>")
    v2 = write_embedding(second, "diffusers", 2, seed=2, token="<style>")
    tp.encode_inputs("a <style> cat", color_map(64), {(255, 0, 0): "cat,1.0"})
    assert tp._encode_cache and tp._text_cache
    for path in (first, second):
        assert ti.apply_textual_inversion(tp, path) == "<style> <style>_1"
        assert jax_ti.apply_textual_inversion(jp, path) == "<style> <style>_1"
        assert not tp._encode_cache and not tp._text_cache
        table = tp.clip.text_model.embeddings.token_embedding.weight
        assert table.shape == (1002, HIDDEN) and tp.config.clip.vocab_size == 1002
        assert tp.clip.config.vocab_size == 1002 and not table.requires_grad
        np.testing.assert_array_equal(
            table.detach().numpy(),
            np.asarray(jp.params["clip"]["params"]["token_embedding"]["embedding"]))
    np.testing.assert_array_equal(table[1000:].detach().numpy(), v2)
    assert tp.tokenizer.added_tokens == jp.tokenizer.added_tokens == {"<style>": 1000,
                                                                      "<style>_1": 1001}


TI_KWARGS = dict(
    prompt="a photo of <cat-toy> <cat-toy>_1 and a dog", color_map_image=color_map(64),
    color_context={(255, 0, 0): "<cat-toy> <cat-toy>_1,1.5", (0, 0, 255): "dog,0.5"},
    num_inference_steps=2, seed=0, noise_mode="torch", return_latents=True,
)


@pytest.fixture(scope="module")
def ti_pair(pair, embedding):
    jp, tp = pair
    assert ti.apply_textual_inversion(tp, embedding) == jax_ti.apply_textual_inversion(
        jp, embedding)
    return jp, tp


def test_placeholder_in_prompt_and_label_matches_jax(ti_pair):
    """The placeholder's ids are in the prompt and bound by a region's PwW
    weights, and the final latents agree with the JAX pipeline's."""
    jp, tp = ti_pair
    enc = tp.encode_inputs(TI_KWARGS["prompt"], TI_KWARGS["color_map_image"],
                           TI_KWARGS["color_context"])
    cols = [p for p, i in enumerate(enc.prompt_ids) if i in (1000, 1001)]
    assert len(cols) == 2
    assert all(float(enc.pww.weights[64][1][:, p].abs().sum()) > 0 for p in cols)
    want = np.asarray(jp.generate(**TI_KWARGS))
    got = tp.generate(**TI_KWARGS)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_caller_latents_match_jax(ti_pair):
    """The same NHWC array as ``latents`` in both pipelines."""
    jp, tp = ti_pair
    lat = np.random.default_rng(7).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jp.generate(latents=lat, **TI_KWARGS))
    got = tp.generate(latents=torch.from_numpy(lat), **TI_KWARGS)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    assert not np.allclose(got, tp.generate(**TI_KWARGS))


def test_caller_latents_shape_is_checked_as_in_jax(ti_pair):
    jp, tp = ti_pair
    bad = np.zeros((1, 4, 8, 8), np.float32)  # NCHW where NHWC is expected
    with pytest.raises(ValueError) as want:
        jp.generate(latents=bad, **TI_KWARGS)
    with pytest.raises(ValueError) as got:
        tp.generate(latents=bad, **TI_KWARGS)
    assert str(got.value) == str(want.value) == "latents shape (1, 4, 8, 8) != (1, 8, 8, 4)"


def test_latents_from_the_seed_give_the_seeded_result_bit_for_bit(pair):
    """No region seeds: ``seed=3`` draws ``make_noise(3)``, so handing that
    noise in, in NHWC, must give the same result; with a region seed the
    regional re-seeding makes them differ."""
    _, tp = pair
    kw = dict(prompt="a cat and a dog", color_map_image=color_map(64),
              color_context={(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5"},
              num_inference_steps=2, return_latents=True)
    noise = make_noise(3, (1, 4, 8, 8)).permute(0, 2, 3, 1)
    seeded = tp.generate(seed=3, **kw)
    np.testing.assert_array_equal(tp.generate(latents=noise, seed=11, **kw), seeded)
    regional = {**kw, "color_context": {(255, 0, 0): "cat,1.5", (0, 0, 255): "dog,0.5,7"}}
    assert not np.array_equal(tp.generate(latents=noise, **regional),
                              tp.generate(seed=3, **regional))


def test_latents_are_ignored_with_an_init_image_as_in_jax(pair):
    """The reference ignores ``latents`` for img2img (ROADMAP C, open)."""
    _, tp = pair
    init = np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    kw = dict(prompt="a cat", color_map_image=color_map(64),
              color_context={(255, 0, 0): "cat,1.0"}, num_inference_steps=4, strength=0.5,
              seed=0, init_image=init, vae_sample_mode="mean", return_latents=True)
    np.testing.assert_array_equal(
        tp.generate(latents=np.ones((1, 8, 8, 4), np.float32), **kw), tp.generate(**kw))


def test_rng_and_sharding_name_their_items(pair):
    """``rng=`` (a jax key's (2,) uint32 data) is accepted: txt2img draws
    nothing from it, as in the JAX pipeline (img2img's draws from it are in
    tests/test_torch_jax_random.py); ``sharding="spatial"`` names A.20b
    (``"batch"`` is the default, run on a mesh in tests/test_torch_sharding.py)."""
    import jax

    _, tp = pair
    kw = dict(prompt="a cat", color_map_image=color_map(64), num_inference_steps=1,
              color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "cat,0.5"},
              return_latents=True)
    np.testing.assert_array_equal(tp.generate(rng=jax.random.PRNGKey(5), **kw),
                                  tp.generate(**kw))
    with pytest.raises(NotImplementedError, match="A.20b"):
        tp.generate(sharding="spatial", **kw)
    assert tp.generate(rng=None, sharding="batch", **kw).shape == (1, 8, 8, 4)
