"""The port's prompt options against the JAX package's: A1111 prompt
weighting, long prompts, CLIP skip, and the encode prologue that takes them
(CPU, f32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.conditioning import encode as jenc
from pww_tpu.conditioning import prompt_weighting as jpw
from pww_tpu.config import CLIPTextConfig as JCLIPTextConfig
from pww_tpu.models.clip import CLIPTextEncoder
from pww_tpu.tokenizer.clip_bpe import toy_tokenizer as jax_toy_tokenizer
from pww_tpu_torch.conditioning import encode as tenc
from pww_tpu_torch.conditioning import prompt_weighting as tpw
from pww_tpu_torch.config import CLIPTextConfig
from pww_tpu_torch.models.clip import CLIPTextModel
from pww_tpu_torch.tokenizer.clip_bpe import toy_tokenizer
from pww_tpu_torch.weights.bridge import params_from_jax
from torch_port_cases import color_map, pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

# f32 on both sides: summation order through a few layers, outputs of order 1
ATOL, RTOL = 2e-4, 2e-4

PROMPTS = [
    "a cat", "a (big) cat", "((big)) cat", "[small] cat", "(cat:1.5) dog",
    "(a (b:2.0) c)", r"\(literal\)", "(unclosed", "", "(neg:-0.5)",
    "unmatched) and ] closers", "[[very small]] (dog:0.8) [cat", "a: b (c: 1.3 ) d",
    r"back\\slash (x:1.2)",
]


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=5)


@pytest.mark.parametrize("text", PROMPTS)
def test_parse_prompt_attention_matches_jax(text):
    """The copied parser: equal fragments and weights."""
    assert tpw.parse_prompt_attention(text) == jpw.parse_prompt_attention(text)


@pytest.mark.parametrize("text", PROMPTS[:8] + ["(cat:1.4) " + "word " * 90])
def test_weighted_prompt_ids_match_jax(text):
    """Equal ids and weights, truncation at 77 included."""
    ids, w = tpw.weighted_prompt_ids(toy_tokenizer(1000), text)
    jids, jw = jpw.weighted_prompt_ids(jax_toy_tokenizer(1000), text)
    assert ids == jids
    np.testing.assert_array_equal(w, jw)


def test_apply_token_weights_matches_jax():
    x = np.random.default_rng(0).standard_normal((77, 32)).astype(np.float32)
    w = np.ones(77, np.float32)
    w[3:6] = (1.5, 0.7, 1.21)
    got = tpw.apply_token_weights(torch.from_numpy(x), w).numpy()
    want = np.asarray(jpw.apply_token_weights(jnp.asarray(x), w))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.mean(), x.mean(), rtol=1e-5)


@pytest.mark.parametrize("n_words", [0, 3, 80, 160])
def test_window_ids_match_jax(n_words):
    text = " ".join(f"word{i}" for i in range(n_words))
    got = tenc._window_ids(toy_tokenizer(1000), text, 77)
    assert got == jenc._window_ids(jax_toy_tokenizer(1000), text, 77)
    assert len(got) == max(1, -(-n_words // 75)) and all(len(w) == 77 for w in got)


@pytest.mark.parametrize("skip", [0, 1, 2])
def test_clip_skip_layers_match_jax(skip):
    """A 3-layer projected tower, every output mode: ``final`` is the final
    LayerNorm of hidden_states[-(k+1)], the penultimate modes take
    hidden_states[-(k+2)], the pooled vector always the full tower."""
    jcfg = JCLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                           num_layers=3, num_heads=4, max_position_embeddings=77,
                           projection_dim=16)
    cfg = CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                         num_layers=3, num_heads=4, max_position_embeddings=77,
                         projection_dim=16)
    ids = np.random.default_rng(1).integers(0, 999, (2, 77))
    ids[:, 30] = 999  # the pooled position: the largest id
    jclip = CLIPTextEncoder(jcfg, dtype=jnp.float32)
    jparams = jclip.init(jax.random.PRNGKey(skip), jnp.asarray(ids, jnp.int32),
                         output="penultimate_and_pooled")
    tclip = CLIPTextModel(cfg)
    tclip.load_state_dict(params_from_jax({"clip": jparams})["clip"], strict=True)
    tids = torch.from_numpy(ids)
    for output in ("final", "penultimate", "penultimate_and_pooled"):
        want = jclip.apply(jparams, jnp.asarray(ids, jnp.int32), output=output,
                           skip_layers=skip)
        got = tclip(tids, output=output, skip_layers=skip)
        want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL,
                                       rtol=RTOL)
    if skip:  # the skip moves the states, not the pooled vector
        full = tclip(tids, output="penultimate_and_pooled")
        cut = tclip(tids, output="penultimate_and_pooled", skip_layers=skip)
        assert not torch.allclose(full[0], cut[0])
        torch.testing.assert_close(full[1], cut[1])
    with pytest.raises(ValueError, match="out of range"):
        tclip(tids, skip_layers=3)


LONG = ("a cat " + " ".join(f"word{i}" for i in range(100)) + " and a dog")
ENCODE_CASES = {  # generate's prompt options and the prompts they take
    "prompt weighting": (dict(prompt_weighting=True), "a (cat:1.4) and a [dog]",
                         "(blurry:1.2)"),
    "long prompt, 2 windows": (dict(long_prompts=True), LONG, "low quality"),
    "clip skip": (dict(clip_skip=1), "a cat and a dog", ""),
    "long prompt with clip skip": (dict(long_prompts=True, clip_skip=1), LONG, ""),
    "weighting with clip skip": (dict(prompt_weighting=True, clip_skip=1),
                                 "a ((cat)) and a dog", ""),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_options_match_jax(pair, case):
    """``encode_inputs`` with each option: text states, the PwW token match
    (the labels are found past the first window), the weight pyramids."""
    jp, tp = pair
    opts, prompt, negative = ENCODE_CASES[case]
    ctx = {(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,0.5"}
    want = jp.encode_inputs(prompt, color_map(64), ctx, negative, **opts)
    got = tp.encode_inputs(prompt, color_map(64), ctx, negative, **opts)
    n_text = 154 if opts.get("long_prompts") else 77
    assert got.text_states.shape == (2, n_text, 32) == want.text_states.shape
    np.testing.assert_allclose(got.text_states.numpy(), np.asarray(want.text_states),
                               atol=ATOL, rtol=RTOL)
    assert got.prompt_ids == want.prompt_ids
    assert got.pww.weights.keys() == want.pww.weights.keys()
    for k, v in want.pww.weights.items():
        np.testing.assert_allclose(got.pww.weights[k].numpy(), np.asarray(v), atol=1e-6)
        assert got.pww.weights[k].shape[-1] == n_text and float(v[1].max()) > 0
    if "long_prompts" not in opts:  # weighting and the skip move the states
        plain = tp.encode_inputs(prompt, color_map(64), ctx, negative)
        assert not torch.allclose(plain.text_states, got.text_states)


def test_long_prompts_refuse_weighting(pair):
    _, tp = pair
    with pytest.raises(ValueError, match="cannot be combined"):
        tp.encode_inputs("a cat", None, {}, long_prompts=True, prompt_weighting=True)
