"""The port's LoRA (pww_tpu_torch.weights.lora, PwwPipeline.load_lora /
unload_loras) against pww_tpu.weights.lora and the JAX pipeline, on the CPU
in f32, on one random parameter tree (tests/torch_port_cases.py).

Tolerances: a merged tensor lies within 1e-6 · max|W| of the JAX merged
leaf (numpy's and torch's f32 products of up and down sum in different
orders); the unload restores every tensor bit for bit; the tiny pipeline's
final latents after ``load_lora`` lie within 2e-5 · max|latents| of the
JAX pipeline's, as tests/test_torch_pipeline.py holds txt2img.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.weights import lora as jlora
from pww_tpu.weights.loader import clip_key, unet_key
from pww_tpu_torch.weights import lora as tlora
from pww_tpu_torch.weights.bridge import params_from_jax
from pww_tpu_torch.weights.safetensors_io import save_file
from torch_port_cases import (color_map, few_torch_threads, pipeline_pair,  # noqa: F401
                              random_jax_params)

KWARGS = dict(prompt="a cat and a dog", color_map_image=color_map(64),
              color_context={(255, 0, 0): "cat,1.0", (0, 0, 255): "dog,0.5"},
              num_inference_steps=2, seed=0, noise_mode="torch", return_latents=True)


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair(seed=0)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _flat(tree):
    """{flax path without 'params': leaf}."""
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key if hasattr(p, "key") else str(p) for p in keypath)
        out[tuple(p for p in path if p != "params")] = leaf
    return out


def _kohya_name(key_fn, path, rank, prefix):
    key, _ = key_fn(path, rank)
    return prefix + "_" + key[: -len(".weight")].replace(".", "_")


def _dense(rng, shape, r=4, alpha=None, conv=False):
    """(down, up) for a flax (in, out) kernel; ``conv``: 4-D LoCon halves."""
    in_dim, out_dim = shape
    down = rng.standard_normal((r, in_dim)).astype(np.float32) * 0.1
    up = rng.standard_normal((out_dim, r)).astype(np.float32) * 0.1
    if conv:
        down, up = down[:, :, None, None], up[:, :, None, None]
    entry = {"lora_down.weight": down, "lora_up.weight": up}
    if alpha is not None:
        entry["alpha"] = np.full((), alpha, np.float32)
    return entry


def _kohya(key_fn, path, rank, prefix, entry):
    name = _kohya_name(key_fn, path, rank, prefix)
    return {f"{name}.{k}": v for k, v in entry.items()}


def _torch_state(tp):
    out = {"unet": tp.unet.state_dict(), "clip": tp.clip.state_dict()}
    if tp.clip2 is not None:
        out["clip2"] = tp.clip2.state_dict()
    return out


def _assert_merged_like_jax(got, jax_tree, keys=None):
    """Every (or each of ``keys``) tensor of the port's merged state dicts
    within 1e-6 · max|W| of the JAX merged tree, bridged."""
    want = params_from_jax({t: jax_tree[t] for t in got})
    for tower, sd in got.items():
        for key in keys.get(tower, ()) if keys is not None else sd:
            w = want[tower][key].numpy()
            err = np.abs(sd[key].numpy() - w).max()
            assert err <= 1e-6 * np.abs(w).max(), (tower, key, err)


def _both_merge(pair, state, scale=1.0):
    jp, tp = pair
    jnew, jn, _ = jlora.merge_lora(jp.params, jlora.parse_lora_state(state), scale)
    tnew, tn, touched = tlora.merge_lora(_torch_state(tp), tlora.parse_lora_state(state), scale)
    assert tn == jn
    return jnew, tnew, touched


def test_kohya_merge_exact_math(pair, rng):
    """A kohya UNet attention entry with alpha and a text-tower entry
    without: merged as JAX merges them and as W + scale·(alpha/r)·up@down;
    untouched tensors are the same objects; restore_params is exact."""
    jp, tp = pair
    fu, fc = _flat(jp.params["unet"]), _flat(jp.params["clip"])
    upath = next(p for p in fu if p[-2:] == ("to_q", "kernel"))
    cpath = next(p for p in fc if p[-2:] == ("q_proj", "kernel"))
    ue = _dense(rng, fu[upath].shape, r=4, alpha=2.0)
    ce = _dense(rng, fc[cpath].shape, r=2)
    state = {**_kohya(unet_key, upath, 2, "lora_unet", ue),
             **_kohya(clip_key, cpath, 2, "lora_te", ce)}
    jnew, tnew, touched = _both_merge(pair, state, scale=0.7)
    ukey, ckey = unet_key(upath, 2)[0], clip_key(cpath, 2)[0]
    _assert_merged_like_jax(tnew, jnew, {"unet": [ukey], "clip": [ckey]})
    before = _torch_state(tp)
    want = before["unet"][ukey] + 0.7 * (2.0 / 4) * torch.from_numpy(
        ue["lora_up.weight"] @ ue["lora_down.weight"])
    torch.testing.assert_close(tnew["unet"][ukey], want, rtol=1e-6, atol=1e-7)
    assert set(touched["unet"]) == {ukey} and set(touched["clip"]) == {ckey}
    assert all(torch.equal(tnew["unet"][k], v) for k, v in before["unet"].items() if k != ukey)
    back = tlora.restore_params(tnew, touched)
    assert all(torch.equal(back[t][k], before[t][k]) for t in back for k in back[t])


def _layout(layout, dkey, entry):
    """One entry in a diffusers-family layout; ``dkey`` the module's
    diffusers path (no ``.weight``)."""
    down, up = entry["lora_down.weight"], entry["lora_up.weight"]
    if layout == "peft":
        return {f"unet.{dkey}.lora_A.weight": down, f"unet.{dkey}.lora_B.weight": up}
    if layout == "legacy diffusers":
        return {f"{dkey}.lora.down.weight": down, f"{dkey}.lora.up.weight": up}
    attn, mod = dkey.rsplit(".", 1)  # the attention-processor form
    return {f"unet.{attn}.processor.{mod}_lora.down.weight": down,
            f"unet.{attn}.processor.{mod}_lora.up.weight": up}


@pytest.mark.parametrize("layout", ["peft", "legacy diffusers", "attention processor"])
def test_diffusers_peft_format_matches_kohya(pair, rng, layout):
    """Each diffusers-family layout merges to the kohya merge bit for bit in
    the port, and as the JAX package merges the same file."""
    jp, _ = pair
    fu = _flat(jp.params["unet"])
    upath = next(p for p in fu if p[-2:] == ("to_v", "kernel"))
    entry = _dense(rng, fu[upath].shape, r=3)
    dkey = unet_key(upath, 2)[0][: -len(".weight")]
    _, kohya, _ = _both_merge(pair, _kohya(unet_key, upath, 2, "lora_unet", entry))
    jnew, tnew, _ = _both_merge(pair, _layout(layout, dkey, entry))
    key = dkey + ".weight"
    assert torch.equal(tnew["unet"][key], kohya["unet"][key])
    _assert_merged_like_jax(tnew, jnew, {"unet": [key]})


@pytest.mark.parametrize("case", ["3x3 resnet conv", "1x1 proj_in conv", "linear on 1x1 proj_out",
                                  "conv on linear to_k"])
def test_conv_locon_entries(pair, rng, case):
    """LoCon entries on 3×3 and 1×1 convs, a linear LoRA on a 1×1 conv
    and a 1×1 conv LoRA on a linear layer, against the JAX merge."""
    jp, _ = pair
    fu = _flat(jp.params["unet"])
    leaf = {"3x3 resnet conv": "conv1", "1x1 proj_in conv": "proj_in",
            "linear on 1x1 proj_out": "proj_out", "conv on linear to_k": "to_k"}[case]
    rank = 2 if case == "conv on linear to_k" else 4
    path = next(p for p in fu if p[-2:] == (leaf, "kernel") and fu[p].ndim == rank)
    shape = fu[path].shape
    r = 2
    if rank == 4 and case != "linear on 1x1 proj_out":
        kh, kw, cin, cout = shape
        entry = {"lora_down.weight": rng.standard_normal((r, cin, kh, kw)).astype(np.float32) * .1,
                 "lora_up.weight": rng.standard_normal((cout, r, 1, 1)).astype(np.float32) * .1}
    else:
        entry = _dense(rng, shape[-2:], r=r, conv=case == "conv on linear to_k")
    jnew, tnew, _ = _both_merge(pair, _kohya(unet_key, path, rank, "lora_unet", entry))
    key = unet_key(path, rank)[0]
    assert not torch.equal(tnew["unet"][key], _torch_state(pair[1])["unet"][key])
    _assert_merged_like_jax(tnew, jnew, {"unet": [key]})


def test_full_attention_coverage(pair, rng):
    """A LoRA on every UNet and text-tower linear weight of an attention or
    an MLP merges every module without a warning, and every merged tensor
    as JAX merges it."""
    jp, _ = pair
    state, count = {}, 0
    for tower, key_fn, prefix in (("unet", unet_key, "lora_unet"), ("clip", clip_key, "lora_te")):
        for path, leaf in _flat(jp.params[tower]).items():
            if path[-1] != "kernel" or leaf.ndim != 2 or not any(
                    s in path[-2] for s in ("to_q", "to_k", "to_v", "to_out", "q_proj", "k_proj",
                                            "v_proj", "out_proj", "fc1", "fc2", "proj_in",
                                            "proj_out")):
                continue
            state.update(_kohya(key_fn, path, 2, prefix, _dense(rng, leaf.shape, r=2)))
            count += 1
    assert count > 10
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jnew, tnew, _ = _both_merge(pair, state)
        assert tlora.merge_lora(_torch_state(pair[1]), tlora.parse_lora_state(state))[1] == count
    _assert_merged_like_jax(tnew, jnew)


def _unet_to_k_lora(jp, rng):
    state = {}
    for path, leaf in _flat(jp.params["unet"]).items():
        if path[-2:] == ("to_k", "kernel"):
            state.update(_kohya(unet_key, path, 2, "lora_unet", _dense(rng, leaf.shape, r=2)))
    return state


def test_pipeline_load_unload_and_output_changes(pair, rng):
    """``load_lora`` on the tiny pipeline: its final latents as the JAX
    pipeline's after its ``load_lora``, unlike the base's; ``unload_loras``
    puts back every tensor bit for bit, and the base latents."""
    jp, tp = pair
    base = tp.generate(**KWARGS)
    before = {t: {k: v.clone() for k, v in sd.items()} for t, sd in _torch_state(tp).items()}
    jbefore = jp.params
    state = _unet_to_k_lora(jp, rng)
    fc = _flat(jp.params["clip"])
    cpath = next(p for p in fc if p[-2:] == ("v_proj", "kernel"))
    state.update(_kohya(clip_key, cpath, 2, "lora_te", _dense(rng, fc[cpath].shape, r=2)))
    try:
        n = tp.load_lora(state, scale=0.8)
        assert n == jp.load_lora(state, scale=0.8) > 1
        got = tp.generate(**KWARGS)
        want = np.asarray(jp.generate(**KWARGS))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
        assert not np.allclose(got, base)
    finally:
        tp.unload_loras()
        jp.unload_loras()
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jp.params),
                                                    jax.tree.leaves(jbefore)))
    after = _torch_state(tp)
    assert all(torch.equal(after[t][k], before[t][k]) for t in before for k in before[t])
    np.testing.assert_array_equal(tp.generate(**KWARGS), base)


def test_lora_stacking_scales(pair, rng):
    """Two ``load_lora`` calls on one module at scales 0.5 and 0.25: the
    JAX pipeline's stacked weights; the unload restores the first original."""
    jp, tp = pair
    fu = _flat(jp.params["unet"])
    upath = next(q for q in fu if q[-2:] == ("to_q", "kernel"))
    key = unet_key(upath, 2)[0]
    orig = tp.unet.state_dict()[key].clone()
    e1, e2 = _dense(rng, fu[upath].shape, r=2), _dense(rng, fu[upath].shape, r=3)
    try:
        for entry, scale in ((e1, 0.5), (e2, 0.25)):
            state = _kohya(unet_key, upath, 2, "lora_unet", entry)
            assert tp.load_lora(state, scale=scale) == jp.load_lora(state, scale=scale) == 1
        _assert_merged_like_jax({"unet": tp.unet.state_dict()}, jp.params, {"unet": [key]})
        want = orig + sum(s * torch.from_numpy(e["lora_up.weight"] @ e["lora_down.weight"])
                          for e, s in ((e1, 0.5), (e2, 0.25)))
        torch.testing.assert_close(tp.unet.state_dict()[key], want, rtol=1e-5, atol=1e-6)
    finally:
        tp.unload_loras()
        jp.unload_loras()
    assert torch.equal(tp.unet.state_dict()[key], orig)


@pytest.fixture(scope="module")
def xl_trees():
    tree = random_jax_params(JaxSDModelConfig.tiny_xl(), seed=3)
    return tree, params_from_jax({t: tree[t] for t in ("unet", "clip", "clip2")})


@pytest.mark.parametrize("unet_names", ["diffusers", "ldm"])
def test_sdxl_te1_te2_routing(xl_trees, rng, unet_names):
    """``lora_te1_``/``lora_te2_`` land on clip / clip2 in both packages. A
    kohya sd-scripts SDXL file names UNet modules in the LDM layout
    (``lora_unet_input_blocks_…``): both packages merge its text entries
    only and warn for every UNet module (ROADMAP C.15)."""
    tree, tstate = xl_trees
    f1, f2, fu = _flat(tree["clip"]), _flat(tree["clip2"]), _flat(tree["unet"])
    p1 = next(p for p in f1 if p[-2:] == ("q_proj", "kernel"))
    p2 = next(p for p in f2 if p[-2:] == ("k_proj", "kernel"))
    up = next(p for p in fu if p[-2:] == ("to_q", "kernel"))
    state = {**_kohya(clip_key, p1, 2, "lora_te1", _dense(rng, f1[p1].shape)),
             **_kohya(clip_key, p2, 2, "lora_te2", _dense(rng, f2[p2].shape))}
    uentry = _dense(rng, fu[up].shape)
    if unet_names == "diffusers":
        state.update(_kohya(unet_key, up, 2, "lora_unet", uentry))
    else:  # down_blocks.1.attentions.0 is LDM's input_blocks.4.1 on SDXL
        name = "lora_unet_input_blocks_4_1_transformer_blocks_0_attn2_to_q"
        state.update({f"{name}.{k}": v for k, v in uentry.items()})
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jnew, jn, _ = jlora.merge_lora(tree, jlora.parse_lora_state(state), 1.0)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tnew, tn, _ = tlora.merge_lora(tstate, tlora.parse_lora_state(state), 1.0)
    assert tn == jn == (3 if unet_names == "diffusers" else 2)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert any("no matching parameter" in str(w.message) for w in tw) == (unet_names == "ldm")
    keys = {"clip": [clip_key(p1, 2)[0]], "clip2": [clip_key(p2, 2)[0]]}
    for tower, (k,) in keys.items():
        assert not torch.equal(tnew[tower][k], tstate[tower][k])
    _assert_merged_like_jax(tnew, jnew, keys)


@pytest.mark.parametrize("case", ["unmatched module", "tower the pipeline lacks",
                                  "unrecognized key", "missing half"])
def test_unmatched_module_warns(pair, case):
    """The port warns as the JAX package does, message for message."""
    z = np.zeros((2, 8), np.float32)
    state = {
        "unmatched module": {"lora_unet_not_a_real_module.lora_down.weight": z,
                             "lora_unet_not_a_real_module.lora_up.weight": z.T.copy()},
        "tower the pipeline lacks": {
            "lora_te2_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight": z,
            "lora_te2_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight": z.T.copy()},
        "unrecognized key": {"something_else.weight": z},
        "missing half": {"lora_unet_conv_in.lora_down.weight": z},
    }[case]
    jp, tp = pair
    msgs = []
    for mod, params in ((jlora, jp.params), (tlora, _torch_state(tp))):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod.merge_lora(params, mod.parse_lora_state(state), 1.0)
        msgs.append([str(w.message) for w in rec])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_lora_file_safetensors(tmp_path, pair, rng, fmt):
    """A file the port writes (kohya, fp16 halves, an alpha) parses to the
    same entries in both packages and merges as JAX merges it."""
    jp, _ = pair
    fu = _flat(jp.params["unet"])
    upath = next(p for p in fu if p[-2:] == ("to_q", "kernel"))
    state = {k: torch.from_numpy(v).half()
             for k, v in _kohya(unet_key, upath, 2, "lora_unet",
                                _dense(rng, fu[upath].shape, alpha=4.0)).items()}
    f = str(tmp_path / f"lora.{fmt}")
    save_file(state, f) if fmt == "safetensors" else torch.save(state, f)
    tl, jl = tlora.load_lora_file(f), jlora.load_lora_file(f)
    assert len(tl) == len(jl) == 1
    (mod, te), = tl.towers["unet"].items()
    je = jl.towers["unet"][mod]
    assert te.alpha == je.alpha == 4.0
    np.testing.assert_array_equal(te.down.numpy(), je.down)
    np.testing.assert_array_equal(te.up.numpy(), je.up)
    jnew, _, _ = jlora.merge_lora(jp.params, jl, 1.0)
    tnew, n, _ = tlora.merge_lora(_torch_state(pair[1]), tl, 1.0)
    assert n == 1
    _assert_merged_like_jax(tnew, jnew, {"unet": [unet_key(upath, 2)[0]]})
