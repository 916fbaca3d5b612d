"""The port's data, tensor and spatial parallelism (pww_tpu_torch/parallel),
serving on a mesh and training through a tp cut, on four gloo ranks on the
CPU, in f32, against the same calls without a mesh, the JAX package's rules,
kernels and unsharded pipeline. One spawn of four ranks runs every
rank-side case (tests/torch_mesh_cases.py); the dry run spawns its own
four."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_cases as C
from pww_tpu.config import SDModelConfig as JaxSDModelConfig
from pww_tpu.parallel.mesh import param_pspec as jax_param_pspec
from pww_tpu_torch.parallel import mesh as M
from pww_tpu_torch.weights.bridge import _leaf, params_from_jax, unet_key
from torch_port_cases import few_torch_threads, random_jax_params  # noqa: F401

# tests/test_sharding.py:77, the sharded UNet against the whole one in f32
UNET_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def tree():
    return random_jax_params(JaxSDModelConfig.tiny(), 0)


@pytest.fixture(scope="module")
def inputs(tree):
    params = params_from_jax(tree)
    ip_embed = np.random.default_rng(5).standard_normal((1, 24)).astype(np.float32)
    return params, C.lora_state(params), ip_embed, C.control_state()


@pytest.fixture(scope="module")
def ranks(inputs):
    """Each rank's results, in rank order."""
    return M.spawn(C.rank_cases, 4, "gloo", *inputs)


@pytest.fixture(scope="module")
def whole(inputs):
    return C.whole_cases(*inputs)


def close(got, want, factor=2e-5):
    """tests/test_torch_pipeline.py:74's tolerance: f32 summation order,
    relative to the largest value."""
    np.testing.assert_allclose(got, want, rtol=0, atol=factor * np.abs(want).max())


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# generate(sharding="spatial") against the call without a mesh, f32: the
# halo convolutions, the moments combined over the rows and the gathered
# keys only reorder f32 sums
SPATIAL_TOL = 1e-5


def test_tp_rules_match_the_jax_rules_on_every_unet_parameter(tree):
    """JAX's P(None, "tp") on a flax (in, out) kernel is the rows of the
    port's (out, in) weight, P("tp", None) the columns, P("tp") on a bias
    its only axis; everything else is whole on both sides."""
    from pww_tpu_torch.weights.bridge import _walk

    dims = {P(None, "tp"): 0, P("tp", None): 1, P("tp"): 0}
    seen = 0
    for path, arr in _walk(tree["unet"]):
        *mods, leaf = path
        key = f"{unet_key(tuple(mods))}.{_leaf(leaf, torch.from_numpy(np.asarray(arr)))[0]}"
        assert M.param_pspec(key) == dims.get(jax_param_pspec("/".join(path))), key
        seen += M.param_pspec(key) is not None
    # per transformer block: q, k, v and to_out of both attentions, GEGLU's
    # proj and its bias, ff.net.2; the tiny UNet has four blocks (down 0,
    # mid, and up 1's two layers)
    assert seen == 11 * 4


@pytest.mark.parametrize("dp,tp", C.MESHES)
def test_sharded_unet_matches_the_whole_one(ranks, whole, dp, tp):
    """The tiny UNet cut over (dp, tp) against the whole one, at every
    reduce mode of a strong PwW bias (sigma 8, weights up to 3), on every
    rank; SAG's gathered mid-block probabilities too."""
    for r, res in enumerate(ranks):
        for mode in C.UNET_MODES:
            np.testing.assert_allclose(res["unet", dp, tp, mode], whole["unet", mode],
                                       err_msg=f"rank {r} {mode}", **UNET_TOL)
            np.testing.assert_allclose(res["sag_probs", dp, tp, mode],
                                       whole["sag_probs", mode], **UNET_TOL)


@pytest.mark.parametrize("mode", C.UNET_MODES)
def test_weight_function_reductions_combine_over_tp(ranks, whole, mode):
    """At tp 4 each rank holds one of the 4 heads: its own max, mean, std or
    callable alone would give another bias. The combined ones match the
    whole UNet, and the bias they give is not the rank-local one."""
    got = ranks[0]["unet", 1, 4, mode]
    np.testing.assert_allclose(got, whole["unet", mode], **UNET_TOL)
    others = [m for m in C.UNET_MODES if m != mode]
    assert all(np.abs(whole["unet", m] - whole["unet", mode]).max() > 1e-3 for m in others)


def test_geglu_is_cut_per_half(ranks, whole):
    """GEGLU's proj stacks [hidden; gate]: each tp rank keeps the same rows
    of both halves, not all of one half."""
    full = whole["geglu"]
    inner = full.shape[0] // 2
    for r, res in enumerate(ranks):
        k = inner // 2
        t = r % 2  # rank = dp index · 2 + tp index on the (2, 2) mesh
        want = np.concatenate([full[t * k:(t + 1) * k], full[inner + t * k:inner + (t + 1) * k]])
        np.testing.assert_array_equal(res["geglu"], want)
    cuts = ranks[0]["tp_cuts"]
    assert all(dim == (1 if re.search(r"to_out|net\.2", k) else 0) for k, (dim, _) in cuts.items())
    assert not any(k.endswith("to_out.0.bias") for k in cuts)  # the bias once, whole


def test_cut_index_blocks_and_halves():
    assert M.cut_index("a.attn1.to_q.weight", 8, 1, 4).tolist() == [2, 3]
    assert M.cut_index("a.ff.net.0.proj.weight", 8, 1, 2).tolist() == [2, 3, 6, 7]
    assert M.cut_index("a.ff.net.0.proj.bias", 8, 0, 4).tolist() == [0, 4]


@pytest.mark.parametrize("dp,tp", C.MESHES)
def test_mesh_generate_matches_jax_and_the_unsharded_port(tree, ranks, whole, dp, tp):
    """``generate(num_samples=4, return_latents=True)`` on every rank of every
    mesh: the whole batch, within f32 summation noise of the port without a
    mesh and of the JAX package's unsharded pipeline on the same weights."""
    want = jax_generate(tree)
    for res in ranks:
        got = res["generate", dp, tp]
        assert got.shape == (4, 8, 8, 4)
        close(got, whole["generate"])
        close(got, want)


_JAX = {}


def jax_generate(tree):
    if "generate" not in _JAX:
        from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline

        jp = JaxPipeline(JaxSDModelConfig.tiny(), params=tree, compute_dtype=jnp.float32,
                         weights_dtype=jnp.float32)
        _JAX["generate"] = np.asarray(jp.generate(color_map_image=C.color_map(), num_samples=4,
                                                  return_latents=True, **C.KW))
    return _JAX["generate"]


@pytest.mark.parametrize("name", ["std", "mean", "custom"])
def test_mesh_weight_functions_match_the_unsharded_port(ranks, whole, name):
    """``std`` and ``mean`` reductions and a callable (split CFG, the heads
    gathered) through ``generate`` on the (2, 2) mesh."""
    for res in ranks:
        close(res["weight_fn", name], whole["weight_fn", name])


def test_sag_under_tp(ranks, whole):
    """SAG's mask takes the mean over every head: the probabilities are
    gathered over tp before it."""
    for res in ranks:
        close(res["sag"], whole["sag"])
    assert np.abs(whole["sag"] - whole["generate"]).max() > 1e-3


def test_stochastic_step_noise_img2img_and_callbacks_cut_the_whole_draw(ranks, whole):
    """The ancestral scheduler's step noise and img2img's posterior sample
    are drawn for the whole batch and cut; the callback sees the gathered
    latents at every visit."""
    for res in ranks:
        close(res["ancestral"], whole["ancestral"])
        close(res["img2img"], whole["img2img"])
        close(res["callback"], whole["generate"])
        assert res["callback_shapes"] == [(4, 8, 8, 4)] * 2


@pytest.mark.parametrize("dp,tp", C.MESHES)
def test_generate_batch_with_per_request_seeds(ranks, whole, dp, tp):
    for res in ranks:
        got = res["batch", dp, tp]
        assert got.shape == (4, 64, 64, 3)
        assert np.abs(got.astype(int) - whole["batch"]).max() <= 1


def test_dp_that_does_not_divide_the_batch_runs_it_whole(ranks, whole):
    for res in ranks:
        close(res["undivided", "generate"], whole["undivided", "generate"])
        assert np.abs(res["undivided", "batch"].astype(int) - whole["undivided", "batch"]).max() <= 1


def test_ranks_return_bit_equal_images(ranks, whole):
    """Every rank returns the same gathered images, within one level of the
    call without a mesh."""
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["images"], ranks[0]["images"])
        for key in [k for k in res if k[0] in ("generate", "batch")]:
            np.testing.assert_array_equal(res[key], ranks[0][key])
    assert ranks[0]["images"].shape == (4, 64, 64, 3)
    assert np.abs(ranks[0]["images"].astype(int) - whole["images"]).max() <= 1


def test_lora_and_ip_adapter_on_a_mesh(inputs, ranks, whole):
    """A LoRA on every attention and feed-forward linear merges into each
    rank's slices as the whole merge cut; unloading restores the slices bit
    for bit; an IP-Adapter attached on the mesh cuts to_k_ip/to_v_ip like
    to_k/to_v (mid block: 64 wide, 2 of 4 heads at tp 2)."""
    for res in ranks:
        assert res["lora_modules"] == len(inputs[1]) // 3 == 40  # 10 linears a block
        close(res["lora"], whole["lora"])
        assert res["lora_restored"]
        close(res["ip"], whole["ip"])
        assert res["ip_cut"] == (32, 32)
    assert np.abs(whole["lora"] - whole["generate"]).max() > 1e-3
    assert np.abs(whole["ip"] - whole["generate"]).max() > 1e-3


def test_collectives_per_visit(ranks):
    """One 1-step call at tp 2: 3 sums per transformer block (to_out of both
    attentions, ff.net.2) and one reduce per PwW cross-attention (max),
    for 4 blocks; no gather."""
    for res in ranks:
        assert res["collectives"] == {"sum": 12, "reduce": 4}


def test_make_mesh_refuses_a_layout_that_is_not_the_world(ranks):
    assert ranks[0]["make_mesh_error"] == "dp(3) * tp(2) != device count (4)"


def test_entry_points_default_to_the_card():
    """Without CUDA, the NCCL group and a CUDA mesh raise; nothing turns to
    gloo or the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_multihost(coordinator_address="localhost:1", num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.spawn(C.rank_cases, 1)


# -- spatial sharding -------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2)])
def test_spatial_txt2img_matches_jax_and_the_unsharded_port(tree, ranks, whole, dp, tp):
    """``generate(sharding="spatial", num_samples=4)``: each rank holds its
    rows of every level (at (4, 1) two of the 8 latent rows, one of the
    mid block's 4), and every rank returns the whole latents, within
    SPATIAL_TOL of the port without a mesh; the (4, 1) run also within the
    mesh tests' factor of the JAX package's unsharded pipeline."""
    for r, res in enumerate(ranks):
        got = res["spatial", dp, tp]
        assert got.shape == (4, 8, 8, 4)
        assert rel_l2(got, whole["generate"]) <= SPATIAL_TOL, r
        if (dp, tp) == (4, 1):
            close(got, jax_generate(tree))
        np.testing.assert_array_equal(got, ranks[0]["spatial", dp, tp])


def test_spatial_collectives_per_call(ranks):
    """The collectives of a spatial call by kind, as chip_smoke.py derives
    them from the config for its gate on the card (halo exchanges, moments
    combines, K/V gathers, reduction combines per UNet visit and per
    decode), plus one gather of the result: 2 visits of the tiny UNet,
    then with the sharded decode; the (2, 2) run adds its tp sums and
    reduces."""
    import chip_smoke
    from pww_tpu_torch.config import SDModelConfig

    latents = dict(chip_smoke.spatial_collectives(SDModelConfig.tiny(), 2, 0), rows=1)
    images = dict(chip_smoke.spatial_collectives(SDModelConfig.tiny(), 2, 1), rows=1)
    assert latents == {"halo": 40, "norm": 42, "kv": 8, "r": 8, "rows": 1}
    for res in ranks:
        assert res["spatial collectives", 4, 1] == latents
        assert res["spatial collectives", 2, 2] == dict(latents, sum=24, reduce=8)
        assert res["spatial images collectives"] == images


def test_spatial_level_that_dp_does_not_divide_runs_whole(ranks, whole):
    """A 32-px map at dp 4: the latents' 4 rows are cut one a rank, the
    mid level's 2 rows run whole on every rank (the downsample gathers its
    input, the upsampler cuts its output)."""
    for res in ranks:
        assert rel_l2(res["spatial undivided"], whole["spatial undivided"]) <= SPATIAL_TOL
        assert res["spatial undivided"].shape == (2, 4, 4, 4)


def test_spatial_decode_is_sharded_and_images_whole(ranks, whole):
    for res in ranks:
        got = res["spatial images"]
        assert got.shape == (2, 64, 64, 3)
        np.testing.assert_array_equal(got, ranks[0]["spatial images"])
        assert np.abs(got.astype(int) - whole["spatial images"]).max() <= 1


@pytest.mark.parametrize("case", list(C.SPATIAL_CASES))
def test_spatial_modes_match_the_unsharded_port(ranks, whole, case):
    """Each mode on the (2, 2) mesh, rows over dp 2 and heads over tp 2,
    against the same call without a mesh: img2img and both inpaintings
    (their init latents, mask and noise cut like the latents), the
    ancestral step noise drawn whole and cut, a custom weight function
    (the site run whole), a std reduction (Chan over rows and heads), SAG
    (the probabilities and the blur on gathered rows), ToMe (the matching
    on gathered rows), FreeU's filter, DeepCache, a ControlNet run whole
    with its residuals cut, an IP-Adapter, SDXL-tiny with its added
    conditions whole, prompt editing, inpainting of the masked area at
    full resolution, an LCM UNet (its guidance embedding whole, its step
    noise drawn whole and cut), a T2I-Adapter (its features computed
    whole, cut by rows per level), the IP-Adapter plus (the image tower
    and the Resampler whole), the SDXL base-to-refiner ensemble (the
    base's gathered latents cut again) and the hires fix in both upscale
    modes (both passes spatial) (uint8 images: within one level)."""
    want = whole["spatial", case]
    for r, res in enumerate(ranks):
        got = res["spatial", case]
        assert got.shape == want.shape
        if got.dtype == np.uint8:
            assert np.abs(got.astype(int) - want).max() <= 1
        else:
            assert rel_l2(got, want) <= SPATIAL_TOL, (r, rel_l2(got, want))
        np.testing.assert_array_equal(got, ranks[0]["spatial", case])
    # the mode changes the result (prompt editing on the tiny random text
    # tower only by ~2e-5; the others are not the plain call's inputs)
    if case == "sdxl ensemble":  # the refiner's visit: tiny synthetic experts, small ε
        assert rel_l2(want, whole["spatial", "sdxl"]) > 1e-5
    elif case.startswith("hires"):  # 128 px images: the second pass ran
        assert want.shape[1:] == (128, 128, 3)
    elif case not in ("euler_ancestral", "sdxl", "inpaint 9-channel", "deepcache",
                      "inpaint full res", "prompt editing"):
        assert rel_l2(want, whole["plain small"]) > 1e-3


def test_spatial_callbacks_see_the_whole_latents(ranks):
    for res in ranks:
        assert res["spatial callback shapes"] == [(2, 8, 8, 4)] * 1


def test_spatial_hires_fix_matches_the_jax_package(tree, ranks):
    """``generate_hires(upscale_mode="latent", sharding="spatial")`` on the
    (2, 2) mesh against the JAX package's unsharded ``generate_hires`` on
    the same weights: the second pass's final latents (the last callback)
    within the mesh tests' factor, the images within one level."""
    want_lat, want_img = jax_hires(tree)
    for res in ranks:
        assert res["spatial hires latents"].shape == (2, 16, 16, 4)
        close(res["spatial hires latents"], want_lat)
        assert np.abs(res["spatial", "hires latent"].astype(int) - want_img).max() <= 1


def jax_hires(tree):
    if "hires" not in _JAX:
        from pww_tpu.pipeline.pipeline import PwwPipeline as JaxPipeline

        jp = JaxPipeline(JaxSDModelConfig.tiny(), params=tree, compute_dtype=jnp.float32,
                         weights_dtype=jnp.float32)
        seen = []
        kw = {k: v for k, v in C.SPATIAL_KW.items() if k not in ("return_latents", "sharding")}
        img = jp.generate_hires(**kw, **C.SPATIAL_CASES["hires latent"], callback_steps=100,
                                callback=lambda i, t, x: seen.append(np.asarray(x)))
        _JAX["hires"] = seen[-1], np.asarray(img)
    return _JAX["hires"]


def test_shard_spatial_cuts_the_rows():
    """shard_spatial without a process group: a mesh stand-in of dp 4."""
    class Mesh:
        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 2

        def size(self, dim):
            return 4

    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 3, 8, 5)
    torch.testing.assert_close(M.shard_spatial(x, Mesh()), x[:, :, 4:6])
    y = x[:, :, :6]  # 6 rows: dp 4 does not divide them, every rank holds all
    assert M.shard_spatial(y, Mesh()) is y


@pytest.mark.parametrize("lq,lk,dh", [(16, 64, 40), (48, 96, 80), (7, 29, 64)])
def test_k3_plain_at_lq_ne_lk_against_the_jax_kernel(lq, lk, dh):
    """K3's plain version with a rank's query rows against every key (Lq ≠
    Lk) equals those rows of the JAX kernel's output on the whole sequence;
    its plain backward equals autograd's."""
    from pww_tpu.ops.flash_attention import flash_self_attention as jax_flash
    from pww_tpu_torch.ops.flash_attention import (self_attention_backward_plain,
                                                   self_attention_plain)

    rng = np.random.default_rng(lq)
    q, k, v = (rng.standard_normal((2, 3, lk, dh)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    r0 = lk - lq  # the last rank's rows
    qt, kt, vt = (torch.from_numpy(a) for a in (q[:, :, r0:], k, v))
    got = self_attention_plain(qt, kt, vt)
    np.testing.assert_allclose(got.numpy(), want[:, :, r0:], rtol=1e-5, atol=1e-5)
    do = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    self_attention_plain(*leaves).backward(do)
    for g, leaf in zip(self_attention_backward_plain(qt, kt, vt, do), leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("silu,with_add", [(False, False), (True, True)])
def test_k4_split_plain_combined_over_rows_against_the_jax_kernel(parts, silu, with_add):
    """Split K4's plain statistics over each block of rows, combined with
    Chan's rule in block order, then the plain apply on each block, equal
    the JAX kernel on the whole tensor at tests/test_torch_norms.py's f32
    limits."""
    from pww_tpu.ops.group_norm import group_norm as jax_group_norm
    from pww_tpu_torch.ops.group_norm import group_norm_apply_plain, group_norm_stats_plain
    from pww_tpu_torch.parallel.spatial import chan_moments

    rng = np.random.default_rng(parts)
    x = (rng.standard_normal((2, 32, 16, 32)) * 2.0 + 0.5).astype(np.float32)  # NHWC
    w = (1.0 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    b = (0.2 * rng.standard_normal(32)).astype(np.float32)
    add = rng.standard_normal((2, 32)).astype(np.float32) if with_add else None
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=4,
                                     eps=1e-5, act="silu" if silu else None,
                                     add=None if add is None else jnp.asarray(add),
                                     force_fused=True))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    at = None if add is None else torch.from_numpy(add)
    blocks = xt.chunk(parts, dim=2)
    stats = torch.stack([group_norm_stats_plain(blk, groups=4, add=at).movedim(-1, 0)
                         for blk in blocks])
    mean, var = chan_moments(stats, blocks[0][0].numel() // 4)
    st = torch.stack([mean, torch.rsqrt(var + 1e-5)], dim=-1)
    got = torch.cat([group_norm_apply_plain(blk, torch.from_numpy(w), torch.from_numpy(b), st,
                                            groups=4, silu=silu, add=at) for blk in blocks],
                    dim=2)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=2e-5, atol=2e-5)


# -- serving on a mesh ---------------------------------------------------------------


def test_batcher_on_rank_0_with_followers_matches_generate_batch(ranks, whole):
    """Rank 0's Batcher fuses 4 requests into one generate_batch on the
    (2, 2) mesh while ranks 1-3 follow; the images match one process's
    generate_batch of the same requests."""
    images, _, last, stats = ranks[0]["serve"]
    assert images.shape == (4, 64, 64, 3)
    assert np.abs(images.astype(int) - whole["batch"]).max() <= 1
    assert np.abs(last.astype(int) - whole["batch last"]).max() <= 1
    assert stats["batches"] == 3 and stats["requests"] == 6


def test_a_bad_request_fails_on_every_rank_and_the_next_group_runs(ranks):
    """A mask without an init image fails generate_batch's validation on
    every rank, before any collective: rank 0's future takes the error
    (after the retry), the followers count the same failed calls, and the
    next group runs on all four ranks."""
    _, error, _, stats = ranks[0]["serve"]
    assert "inpainting requires init_image" in error and stats["retries"] == 1
    for res in ranks[1:]:
        assert res["serve"] == {"calls": 4, "errors": 2}


# -- training through a tp cut -----------------------------------------------------


def test_tp_unet_gradients_match_the_whole_unet(ranks, whole):
    """The UNet cut over tp 2 (on the (2, 2) mesh): the gradient with
    respect to the latents and to the text states (the path of textual
    inversion's gradient, through every cross-attention's to_k / to_v) is
    the whole UNet's."""
    for res in ranks:
        for got, want in zip(res["grads"], whole["grads"]):
            assert rel_l2(got, want) <= 1e-5


# 2 Adam steps at tp 2 against one process, f32: the losses within 1e-6
# relative, the embedding and the factors (all sites together) within 1e-5
# relative L2 (a factor near zero takes Adam's sign-like first step on a
# gradient of a few ulps, so single small factors are not held alone)
TRAIN_TOL = dict(loss=1e-6, tensors=1e-5)


def test_tp_training_matches_one_process(ranks, whole):
    emb_w, ti_w, fac_w, lora_w = whole["train"]
    keys = sorted(fac_w)
    flat_w = np.concatenate([fac_w[k][n].ravel() for k in keys for n in "ab"])
    for res in ranks:
        emb, ti, fac, lora = res["train"]
        np.testing.assert_allclose(ti, ti_w, rtol=TRAIN_TOL["loss"])
        np.testing.assert_allclose(lora, lora_w, rtol=TRAIN_TOL["loss"])
        assert rel_l2(emb, emb_w) <= TRAIN_TOL["tensors"]
        assert sorted(fac) == keys
        assert all(fac[k][n].shape == fac_w[k][n].shape for k in keys for n in "ab")
        flat = np.concatenate([fac[k][n].ravel() for k in keys for n in "ab"])
        assert rel_l2(flat, flat_w) <= TRAIN_TOL["tensors"]
        assert res["train collectives"]["grad_sum"] > 0


def test_gathered_lora_factors_and_embeddings_are_equal_on_every_rank(ranks):
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["train"][0], ranks[0]["train"][0])
        for k, f in res["train"][2].items():
            for n in "ab":
                np.testing.assert_array_equal(f[n], ranks[0]["train"][2][k][n])


def test_dryrun_at_world_size_4(capsys):
    from pww_tpu_torch.parallel import dryrun

    assert dryrun.main(["--world-size", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: dp=2 tp=2 over 4 ranks (cpu)"
    cases = ["denoise step", "mesh generate", "mesh SDXL generate",
             "mesh custom-weight-fn generate", "mesh inpaint generate",
             "mesh generate_batch img2img", "textual-inversion grad step"]
    assert [line.split(" ok:")[0] for line in out[1:]] == cases
    diffs = [float(line.rsplit(" ", 1)[1]) for line in out if "max |" in line]
    assert diffs[0] < 2e-4 and diffs[1] < 1e-7
