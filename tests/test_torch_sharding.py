"""The port's data and tensor parallelism (pww_tpu_torch/parallel) on four
gloo ranks on the CPU, in f32, against the same calls without a mesh, the
JAX package's rules and its unsharded pipeline. One spawn of four ranks
runs every rank-side case (tests/torch_mesh_cases.py); the dry run spawns
its own four."""
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
    return params, C.lora_state(params), ip_embed


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


def test_trainers_and_the_batcher_refuse_a_mesh_pipeline(ranks):
    """Training through a UNet cut over tp (its collectives carry no
    gradient) and serving on a mesh (only rank 0 would form the groups)
    raise, naming A.20b, before the tokenizer changes."""
    for res in ranks:
        assert set(res["refusals"]) == {"textual inversion", "lora", "batcher"}
        assert all("A.20b" in msg for msg in res["refusals"].values())
        assert not res["tokenizer_grew"]


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


def test_spatial_sharding_names_its_roadmap_item(inputs):
    with pytest.raises(NotImplementedError, match="A.20b"):
        C.pipeline(inputs[0]).generate(prompt="a cat", color_map_image=C.color_map(), num_inference_steps=1,
                    sharding="spatial")
    with pytest.raises(NotImplementedError, match="A.20b"):
        M.shard_spatial(None, None)


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
