"""The port's training (textual inversion and LoRA) and K3 under autograd,
against the JAX package (CPU, f32 on both sides).

* K3's plain backward and its autograd Function against ``jax.grad`` of the
  dense ``pww_tpu.ops.attention.pww_attention``, the path K3 replaces;
* the gradient through the port's UNet at head dim 40, with the Function
  at the self-attention sites, against ``jax.grad`` through the JAX UNet
  with ``flash_attention=False`` (the JAX K3 has no gradient: ROADMAP.md
  C.18, recorded by the last test);
* each trainer's draws (LoRA's initial A, every step's indices,
  timesteps and noise) against ``jax.random`` split as
  ``pww_tpu/training/textual_inversion.py:172-179, 202-206`` and
  ``pww_tpu/training/lora.py:134-141, 177-183, 204-208`` split them;
* three steps of each port trainer, end to end from the seed, against the
  JAX trainers on the tiny config: losses, trained tensors, tokenizer ids,
  the saved files; the refusals of both packages.

One JAX training compile per trainer, in a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.models.unet import UNet2DCondition as JaxUNet
from pww_tpu.ops.attention import pww_attention as jax_pww_attention
from pww_tpu.ops.flash_attention import flash_self_attention as jax_flash_self_attention
from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline
from pww_tpu.training import train_lora as jax_train_lora
from pww_tpu.training import train_textual_inversion as jax_train_textual_inversion
from pww_tpu.training.lora import _target_paths
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.models import unet as tunet
from pww_tpu_torch.ops import cuda_build
from pww_tpu_torch.ops import flash_attention as fa
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.training import (DEFAULT_TARGETS, DEFAULT_TEMPLATES, LoraTrainResult,
                                    train_lora, train_textual_inversion)
from pww_tpu_torch.training.lora import LoraTrainer, target_sites
from pww_tpu_torch.training.textual_inversion import TextualInversionTrainer
from pww_tpu_torch.weights.bridge import unet_key
from test_torch_models import pair_dh40  # noqa: F401 (fixture)
from torch_port_cases import pipeline_pair, few_torch_threads  # noqa: F401 (autouse)

STEPS, BATCH = 3, 2
TI_LR, LORA_LR, RANK = 1e-2, 5e-3, 2


def _images(n=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray((rng.random((size, size, 3)) * 80 + 100).astype(np.uint8))
            for _ in range(n)]


def _split_draws(key, n_keys):
    """The JAX loop's per-step keys: ``rng, k = split(rng)``, then ``k`` split
    into ``n_keys``."""
    keys = []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        keys.append(jax.random.split(k, n_keys))
    return keys


def _eps(k, shape):
    """The JAX step's NHWC noise as the port's NCHW."""
    e = np.asarray(jax.random.normal(k, shape, jnp.float32))
    return torch.from_numpy(e).permute(0, 3, 1, 2).contiguous()


def _randint(k, hi):
    return torch.from_numpy(np.array(jax.random.randint(k, (BATCH,), 0, hi))).long()


# -- K3 under autograd ---------------------------------------------------------

@pytest.mark.parametrize("chunk_pairs", [None, 1])
def test_k3_backward_matches_jax_grad_of_dense_attention(chunk_pairs, monkeypatch):
    """dQ, dK, dV of the plain backward and of the Function (default chunks,
    and one (sample, head) pair a chunk) against ``jax.vjp`` of the dense
    attention, f32: atol 5e-6, rtol 1e-5 (summation order; 4e-7 seen)."""
    b, h, l, dh = 2, 2, 64, 40
    if chunk_pairs:
        monkeypatch.setattr(fa, "BACKWARD_CHUNK_BYTES", chunk_pairs * l * l * 4)
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((b, h, l, dh)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda *x: jax_pww_attention(*x), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_self_attention(tq, tk, tv)
    assert out.grad_fn is not None and "FlashSelfAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    plain = fa.self_attention_backward_plain(*map(torch.from_numpy, (q, k, v, do)))
    for got, pl, w in zip((tq.grad, tk.grad, tv.grad), plain, want):
        np.testing.assert_allclose(got.numpy(), w, atol=5e-6, rtol=1e-5)
        np.testing.assert_allclose(pl.numpy(), w, atol=5e-6, rtol=1e-5)
        assert pl.dtype == torch.float32


def test_k3_backward_returns_the_inputs_dtype_and_inference_is_unchanged():
    """bf16 inputs give bf16 grads; under no_grad or inference_mode the
    wrapper returns the forward without the Function."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 32, 40), generator=g).bfloat16() for _ in range(3))
    grads = fa.self_attention_backward_plain(q, k, v, torch.ones_like(q))
    assert all(x.dtype == torch.bfloat16 and x.shape == q.shape for x in grads)
    qg = q.clone().requires_grad_(True)
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            out = fa.flash_self_attention(qg, k, v)
        assert out.grad_fn is None
        torch.testing.assert_close(out, fa.self_attention_plain(q, k, v), atol=0, rtol=0)


def test_kernels_without_a_backward_refuse_a_gradient():
    """``refuse_grad`` (K1, K2, K4 and K5 on the card) raises under grad mode
    on inputs that require a gradient, naming ROADMAP.md §B, and lets
    no_grad calls and frozen inputs through."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward.*ROADMAP.md §B"):
        cuda_build.refuse_grad("fused_pww_reduce", x, torch.ones(2))
    with torch.no_grad():
        cuda_build.refuse_grad("fused_pww_reduce", x)
    cuda_build.refuse_grad("group_norm", torch.ones(2), None)


def test_unet_gradient_through_k3_matches_jax(pair_dh40, monkeypatch):
    """Head dim 40, ``flash_min_seq`` 256 at a 16×16 latent: the Function
    carries the three L-256 self-attention sites (three forwards, three
    plain backwards). The gradient of Σ(out·c) with respect to the sample
    and the text states, against ``jax.grad`` through the JAX UNet with
    ``flash_attention=False``: within 2e-5 of the largest gradient (f32,
    summation order through a few dozen layers; 2.7e-6 seen)."""
    jp, tp = pair_dh40
    rng = np.random.default_rng(5)
    sample = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    cot = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    t = 601.0

    unet = JaxUNet(dataclasses.replace(jp.config.unet, flash_attention=False),
                   dtype=jnp.float32)
    loss = lambda x, c: jnp.sum(unet.apply(jp.params["unet"], x, jnp.float32(t), c)  # noqa: E731
                                * jnp.asarray(cot))
    want = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(sample),
                                                                   jnp.asarray(ctx))]

    tcfg = dataclasses.replace(tp.config.unet, flash_min_seq=256)
    for m in tp.unet.modules():
        if isinstance(m, tunet.Attention):
            monkeypatch.setattr(m, "cfg", tcfg)
    calls = {"forward": 0, "backward": 0}

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tunet, "flash_self_attention", spy("forward", tunet.flash_self_attention))
    monkeypatch.setattr(fa, "self_attention_backward_plain",
                        spy("backward", fa.self_attention_backward_plain))
    x = torch.from_numpy(sample).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    c = torch.from_numpy(ctx).requires_grad_(True)
    out = tp.unet(x, torch.tensor(t), c)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert calls == {"forward": 3, "backward": 3}
    for got, w in ((x.grad.permute(0, 2, 3, 1), want[0]), (c.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


def test_jax_flash_attention_has_no_gradient_where_the_ports_has_one():
    """ROADMAP.md C.18: ``jax.grad`` through the JAX K3 (interpret mode on the
    CPU) raises, so the reference trains only where no site reaches
    ``flash_min_seq``; the port's K3 carries a gradient, equal to the
    dense one's (atol 5e-6)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, 256, 40)).astype(np.float32) for _ in range(3))
    loss = lambda q: jnp.sum(jax_flash_self_attention(q, jnp.asarray(k), jnp.asarray(v),  # noqa: E731
                                                      block=256) ** 2)
    with pytest.raises(AssertionError):
        jax.grad(loss)(jnp.asarray(q))
    dense = jax.grad(lambda q: jnp.sum(jax_pww_attention(q, jnp.asarray(k),
                                                         jnp.asarray(v)) ** 2))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    (fa.flash_self_attention(tq, torch.from_numpy(k), torch.from_numpy(v)) ** 2).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(dense), atol=5e-6, rtol=1e-5)


# -- textual inversion ---------------------------------------------------------

@pytest.fixture(scope="module")
def ti_runs():
    """Both packages' trainers, 3 steps from seed 0, on one tiny pipeline
    pair."""
    jp, tp = pipeline_pair(seed=6)
    images = _images()
    table0 = tp.clip.text_model.embeddings.token_embedding.weight.clone()
    want = jax_train_textual_inversion(jp, images, "<my-thing>", initializer_token="thing",
                                       num_steps=STEPS, batch_size=BATCH,
                                       learning_rate=TI_LR, seed=0)
    got = train_textual_inversion(tp, images, "<my-thing>", initializer_token="thing",
                                  num_steps=STEPS, batch_size=BATCH, learning_rate=TI_LR,
                                  seed=0)
    return jp, tp, want, got, table0


def test_trainer_draws_match_jax():
    """Every step's draws of both port trainers equal the JAX loops' (the
    indices and timesteps exactly, ε within 1e-6), and LoRA's initial A
    equals ``normal(fold_in(PRNGKey(seed), i))/r`` in the JAX tree's site
    order (within 1e-6)."""
    from pww_tpu_torch.utils import jax_random

    jp, tp = pipeline_pair(seed=6)
    images = _images()
    ti = TextualInversionTrainer(tp, images, "<drawn>", "thing")
    lora = LoraTrainer(tp, images, "a photo", rank=RANK)
    shape = (BATCH, *ti.latents.shape[2:], 4)
    for trainer, seed, n_keys in ((ti, 0, 4), (lora, 1, 3)):
        key = jax_random.PRNGKey(seed)
        for keys in _split_draws(jax.random.PRNGKey(seed), n_keys):
            key, k = jax_random.split(key)
            got = trainer.draws(k, BATCH)
            highs = ([len(images), len(DEFAULT_TEMPLATES)] if n_keys == 4 else [len(images)])
            highs.append(tp.config.scheduler.num_train_timesteps)
            for g, kk, hi in zip(got[:-1], keys[:-1], highs):
                assert torch.equal(g, _randint(kk, hi))
            np.testing.assert_allclose(got[-1].numpy(), _eps(keys[-1], shape).numpy(),
                                       atol=1e-6, rtol=0)
    factors, _ = lora.init(0, LORA_LR)
    for i, (_, path) in enumerate(_target_paths(jp.params["unet"], DEFAULT_TARGETS)):
        key = unet_key(path[:-1]) + ".weight"
        w = lora.base[key]
        want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), i),
                                            (w.shape[1], RANK), jnp.float32)) / RANK
        np.testing.assert_allclose(factors[key]["a"].detach().numpy(), want, atol=1e-6)


def test_textual_inversion_steps_match_jax(ti_runs):
    """Per-step losses within 2e-6 relative (2.2e-7 seen); the trained row
    within 2e-5 (three Adam steps of 1e-2 on f32 gradients; 2.1e-6 seen);
    the installed tables alike, the old rows bit-equal to before."""
    jp, tp, want, got, table0 = ti_runs
    np.testing.assert_allclose(got.losses, want.losses, rtol=2e-6)
    np.testing.assert_allclose(got.embedding.numpy(), want.embedding, atol=2e-5)
    table = tp.clip.text_model.embeddings.token_embedding.weight
    jtable = np.asarray(jp.params["clip"]["params"]["token_embedding"]["embedding"])
    assert table.shape == jtable.shape == (1001, 32)
    assert tp.config.clip.vocab_size == jp.config.clip.vocab_size == 1001
    assert torch.equal(table[:1000], table0)
    np.testing.assert_allclose(table.numpy(), jtable, atol=2e-5)
    assert not torch.allclose(table[1000], table0[tp.tokenizer("thing")["input_ids"][1]])


def test_textual_inversion_tokens_and_file_match_jax(ti_runs, tmp_path):
    """The placeholder, its id in both tokenizers, a prompt's ids, and the
    saved ``{placeholder: vec}`` files (the vectors within 2e-5)."""
    jp, tp, want, got, _ = ti_runs
    assert got.placeholder == want.placeholder == "<my-thing>"
    assert tp.tokenizer.convert_tokens_to_ids("<my-thing>") == 1000
    assert jp.tokenizer.convert_tokens_to_ids("<my-thing>") == 1000
    prompt = "a photo of <my-thing> on a table"
    assert tp.tokenizer(prompt)["input_ids"] == jp.tokenizer(prompt)["input_ids"]
    want.save(str(tmp_path / "jax.bin"))
    got.save(str(tmp_path / "port.bin"))
    a, b = (torch.load(str(tmp_path / f), weights_only=True) for f in ("jax.bin", "port.bin"))
    assert list(a) == list(b) == ["<my-thing>"]
    assert a["<my-thing>"].shape == b["<my-thing>"].shape == (32,)
    np.testing.assert_allclose(b["<my-thing>"].numpy(), a["<my-thing>"].numpy(), atol=2e-5)


def test_train_textual_inversion_entry_point_installs_and_generates():
    """The port's own loop: losses finite, only the new rows trained, the
    caches dropped, a prompt with the placeholder generates."""
    tp = PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, seed=2)
    before = tp.clip.text_model.embeddings.token_embedding.weight.clone()
    tp._text_cache["stale"] = 1
    res = train_textual_inversion(tp, _images(1), "<cat-toy>", num_vectors=2, num_steps=2)
    table = tp.clip.text_model.embeddings.token_embedding.weight
    assert res.placeholder == "<cat-toy> <cat-toy>_1" and res.embedding.shape == (2, 32)
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert torch.equal(table[:1000], before) and torch.equal(table[1000:], res.embedding)
    assert not table.requires_grad and not tp._text_cache
    cm = np.zeros((64, 64, 3), np.uint8)
    cm[:, :32] = (255, 0, 0)
    img = tp.generate(prompt=f"a photo of {res.placeholder}", color_map_image=cm,
                      color_context={(255, 0, 0): f"{res.placeholder},1.0"},
                      num_inference_steps=2, seed=0, output_type="np")
    assert img.shape == (1, 64, 64, 3)


# -- LoRA ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def lora_runs():
    jp, tp = pipeline_pair(seed=7)
    images = _images(seed=1)
    caption = "a photo of a thing"
    unet0 = {k: v.clone() for k, v in tp.unet.state_dict().items()}
    want = jax_train_lora(jp, images, caption, rank=RANK, num_steps=STEPS, batch_size=BATCH,
                          learning_rate=LORA_LR, seed=0)
    factors, _ = LoraTrainer(tp, images, caption, rank=RANK).init(0, LORA_LR)
    a0 = {key: f["a"].detach().clone() for key, f in factors.items()}
    got = train_lora(tp, images, caption, rank=RANK, num_steps=STEPS, batch_size=BATCH,
                     learning_rate=LORA_LR, seed=0)
    return jp, tp, want, got, unet0, a0


def test_lora_steps_match_jax(lora_runs):
    """Per-step losses within 2e-6 relative; every factor, by site name,
    within 2e-5 (three Adam steps of 5e-3; 7e-7 seen); the pipeline's UNet
    bit-equal to before; every B nonzero and every A moved after step 3."""
    jp, tp, want, got, unet0, a0 = lora_runs
    np.testing.assert_allclose(got.losses, want.losses, rtol=2e-6)
    assert len(got.factors) == len(want.factors) == 32
    for path, f in want.factors.items():
        g = got.factors[unet_key(path[:-1]) + ".weight"]
        for name in ("a", "b"):
            np.testing.assert_allclose(g[name].numpy(), f[name], atol=2e-5, err_msg=str(path))
        assert g["b"].abs().max() > 0
        assert not torch.equal(g["a"], a0[unet_key(path[:-1]) + ".weight"])
    assert all(torch.equal(v, unet0[k]) for k, v in tp.unet.state_dict().items())
    assert not any(p.requires_grad for p in tp.unet.parameters())


def test_lora_state_dict_and_file_match_jax(lora_runs, tmp_path):
    """``state_dict()`` has the JAX one's keys, shapes and values (2e-5);
    both packages' files load through the port's ``load_lora`` into every
    site, to merged weights within 5e-6 of each other (8.5e-7 seen)."""
    from safetensors.numpy import save_file as jax_save_file

    jp, tp, want, got, unet0, _ = lora_runs
    jsd, tsd = want.state_dict(), got.state_dict()
    assert set(jsd) == set(tsd) and len(tsd) == 3 * 32
    for key, w in jsd.items():
        assert tuple(tsd[key].shape) == w.shape
        np.testing.assert_allclose(tsd[key].numpy(), w, atol=2e-5, err_msg=key)
    got.save(str(tmp_path / "port.safetensors"))
    jax_save_file(jsd, str(tmp_path / "jax.safetensors"))
    merged = {}
    for name in ("port", "jax"):
        assert tp.load_lora(str(tmp_path / f"{name}.safetensors")) == 32
        merged[name] = {k: v.clone() for k, v in tp.unet.state_dict().items()}
        tp.unload_loras()
    assert all(torch.equal(v, unet0[k]) for k, v in tp.unet.state_dict().items())
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    f = got.factors[key]
    torch.testing.assert_close(merged["port"][key], unet0[key] + (f["a"] @ f["b"]).T,
                               atol=1e-6, rtol=1e-6)
    for k in unet0:
        np.testing.assert_allclose(merged["port"][k].numpy(), merged["jax"][k].numpy(),
                                   atol=5e-6, err_msg=k)


def test_lora_sites_and_entry_point():
    """``target_sites`` picks the attention linears (``to_out`` as
    ``to_out.0``) and a subset on request; ``train_lora`` draws its initial
    A from the seed, keeps B = 0 before a step, and returns its losses."""
    tp = PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, seed=3)
    sites = target_sites(tp.unet, DEFAULT_TARGETS)
    assert len(sites) == 32 and all(".attn" in s for s in sites)
    assert sum(s.endswith("to_out.0.weight") for s in sites) == 8
    assert len(target_sites(tp.unet, ("to_q",))) == 8
    with pytest.raises(ValueError, match="no UNet attention weights"):
        LoraTrainer(tp, _images(1), "x", targets=("nothing",))
    runs = [train_lora(tp, _images(1), "a thing", rank=4, alpha=2.0, num_steps=n, seed=seed)
            for n, seed in ((0, 5), (0, 5), (0, 6), (1, 5))]
    assert isinstance(runs[0], LoraTrainResult) and runs[0].losses == []
    assert runs[0].alpha == 2.0 and runs[0].rank == 4
    for key, f in runs[0].factors.items():
        assert f["a"].shape == (tp.unet.get_parameter(key).shape[1], 4) and not f["b"].any()
        assert torch.equal(f["a"], runs[1].factors[key]["a"])
        assert not torch.equal(f["a"], runs[2].factors[key]["a"])
        assert runs[3].factors[key]["b"].abs().max() > 0  # B moves at step 1, A after it
        assert torch.equal(f["a"], runs[3].factors[key]["a"])
    assert len(runs[3].losses) == 1 and np.isfinite(runs[3].losses[0])


# -- refusals ------------------------------------------------------------------

def _shell(cls, config):
    """A pipeline with a config alone: a refusal must come before any other
    attribute is read."""
    shell = cls.__new__(cls)
    shell.config = config
    return shell


@pytest.mark.parametrize("package", ["jax", "port"])
def test_xl_and_caption_count_refusals_in_both_packages(package):
    if package == "jax":
        ti, lora, cls, cfg = (jax_train_textual_inversion, jax_train_lora, JaxPipeline,
                              JaxSDModelConfig)
    else:
        ti, lora, cls, cfg = train_textual_inversion, train_lora, PwwPipeline, SDModelConfig
    xl = _shell(cls, cfg.tiny_xl())
    with pytest.raises(NotImplementedError, match="single-encoder"):
        ti(xl, _images(1), "<x>")
    with pytest.raises(NotImplementedError, match="single-encoder"):
        lora(xl, _images(1), "a thing")
    with pytest.raises(ValueError, match="one caption per image"):
        lora(_shell(cls, cfg.tiny()), _images(2), ["a", "b", "c"])


def test_training_exports_the_jax_packages_names():
    """``pww_tpu_torch.training`` has ``pww_tpu.training``'s six names, and
    the templates and targets are the JAX package's."""
    import pww_tpu.training as jax_training
    import pww_tpu_torch.training as training

    assert training.__all__ == jax_training.__all__ and len(training.__all__) == 6
    assert all(hasattr(training, n) for n in training.__all__)
    assert DEFAULT_TEMPLATES == jax_training.DEFAULT_TEMPLATES
    assert DEFAULT_TARGETS == jax_training.DEFAULT_TARGETS
