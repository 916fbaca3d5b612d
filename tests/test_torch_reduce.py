"""K1, the port's paint-with-words score reduction: its plain version against
the JAX package's Pallas kernel on bf16 inputs (interpret mode, CPU), then
the CUDA kernel's launch plan at the paths' signatures (pure Python; the
kernel runs on the card, where ``chip_smoke.py`` holds it against the plain
version).
"""
import re

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.ops import cross_attention_kernel as jxk
from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu_torch.ops import cuda_build
from pww_tpu_torch.ops import cross_attention_kernel as txk
from pww_tpu_torch.ops.weight_functions import WeightFunction
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("dh", [40, 80])
@pytest.mark.parametrize("mode,mean", [("max", 0.0), ("mean", 0.0), ("std", 0.0), ("std", 4.0)])
def test_bf16_jax_reduce_sits_within_the_card_limit_of_the_plain_version(mode, mean, dh):
    """Both sum exact products of bf16 values in f32, in another order; on
    the same bf16 inputs they must agree within the limit the card holds
    the CUDA kernel to, 1e-4·max(1, |r|) (|mean| ≫ std included)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 2, 512, dh)).astype(np.float32) + mean
    k = rng.standard_normal((2, 2, 77, dh)).astype(np.float32) + mean
    want = np.asarray(jxk.fused_pww_reduce(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        JWeightFunction(0.1, "log1p_sigma", mode), block_q=256))
    got = txk.pww_cross_attention_reduce(
        torch.tensor(q).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16),
        WeightFunction(0.1, "log1p_sigma", mode)).numpy()
    assert got.dtype == np.float32 and got.shape == (2,)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


# (B, H, Lq, Lk, dh): SD-1.5's three sites at 512², ragged Lq, two and four
# prompt chunks, SD-2.x's head dim 64 at 768², and K split across CTAs
PLAN_CASES = [(2, 8, 4096, 77, 40), (2, 8, 1024, 77, 80), (2, 8, 256, 77, 160),
              (2, 8, 4000, 77, 40), (2, 8, 4096, 154, 40), (2, 8, 256, 308, 160),
              (2, 5, 9216, 77, 64), (2, 20, 576, 77, 64), (2, 8, 256, 2000, 160)]


@pytest.mark.parametrize("b,h,lq,lk,dh", PLAN_CASES)
def test_pww_reduce_plan(b, h, lq, lk, dh):
    """Every (b·h, query row, key) falls to exactly one warp of one CTA, as
    ``csrc/pww_reduce.cu`` decodes the CTA index; no CTA is empty; the
    shared memory fits; the grid holds 7/8 of a wave of the H100's 132 SMs
    wherever there are that many 16-row tiles; the partials of a sample are
    contiguous."""
    plan = txk.pww_reduce_plan(b, h, lq, lk, dh)
    assert plan.warps in (1, 2, 4, 8) and plan.tiles >= 1
    assert plan.ctas == b * h * plan.row_splits * plan.key_splits and plan.ctas % b == 0
    assert plan.smem_bytes == txk._reduce_smem_bytes(dh, plan.warps, plan.tiles, plan.key_chunks)
    assert plan.smem_bytes <= txk.SMEM_PER_CTA == 232_448
    keys = 80 * plan.key_chunks
    cover = np.zeros((b * h, lq, lk), np.uint8)
    for cta in range(plan.ctas):
        ks = cta % plan.key_splits
        rs = cta // plan.key_splits % plan.row_splits
        bh = cta // (plan.key_splits * plan.row_splits)
        assert rs * plan.rows < lq and ks * keys < lk  # at least one row and one key
        for w in range(plan.warps):
            r0 = (rs * plan.warps + w) * plan.tiles * 16
            cover[bh, r0:r0 + plan.tiles * 16, ks * keys:(ks + 1) * keys] += 1
    assert (cover == 1).all()
    if 8 * b * h * -(-lq // 16) * plan.key_splits >= 7 * 132:
        assert 8 * plan.ctas >= 7 * 132


def test_pww_reduce_plan_spreads_small_lq_and_keeps_k_whole():
    """Lq 256 at dh 160 (64 tiles of 64 rows) takes CTAs of two warps to
    reach the SMs; K stays whole beside two warps' Q rings up to 560 keys at
    dh 160 (seven chunks) and is split past that."""
    assert txk.pww_reduce_plan(2, 8, 256, 77, 160).warps == 2
    assert txk.pww_reduce_plan(2, 8, 256, 560, 160).key_splits == 1
    assert txk.pww_reduce_plan(2, 8, 256, 2000, 160).key_splits > 1


@pytest.mark.parametrize("dh", [32, 48, 96, 128])
def test_pww_reduce_plan_refuses_other_head_dims(dh):
    """The kernel is instantiated for HEAD_DIMS only; the wrapper asks the
    plan before it launches."""
    with pytest.raises(ValueError, match="head dim"):
        txk.pww_reduce_plan(2, 8, 1024, 77, dh)


def test_profile_groups_name_the_kernels():
    """``chip_smoke.py`` reads K1-K5's device time and kernels per call from
    the profiler by name: each group's fragment names a ``__global__``
    function of the kernel's source, and only of that one."""
    kernels = {}
    for source in cuda_build.SOURCES:
        with open(f"{cuda_build.CSRC_DIR}/{source}.cu") as f:
            text = f.read()
        kernels[source] = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)",
                                     text)
    for group, frags in chip_smoke.GROUPS[:5]:
        name = next(n for n, (_, _, _, g, _) in chip_smoke.KERNELS.items() if g == group)
        source = chip_smoke.KERNELS[name][0].rsplit("/", 1)[1][:-3]
        for other, names in kernels.items():
            hit = any(f in n.lower() for f in frags for n in names)
            assert hit is (other == source), (group, other, names)
