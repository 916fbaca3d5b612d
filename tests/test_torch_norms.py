"""K4 and K5, the port's GroupNorm and LayerNorm, against the JAX package's
Pallas kernels in interpret mode (CPU); then the CUDA kernels' launch plans
at every site of the inpaint path (``chip_smoke.py``'s tables).

The JAX kernels run as ``tests/test_group_norm.py`` runs them
(``force_fused=True``), both GroupNorm schemes included: the whole-row
kernel, and the chunked stats/apply pair when ``whole_row_bytes`` is below
the slab. The port's wrappers take their plain versions on CPU tensors.
Inputs come from a numpy seed; the JAX side is channel-last (N, H, W, C),
the port NCHW, so the inputs and outputs are transposed between them.
"""
import math

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.ops.group_norm import _reference_group_norm
from pww_tpu.ops.group_norm import group_norm as jax_group_norm
from pww_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from pww_tpu_torch.ops.group_norm import (CLUSTER_SIZES, SMEM_PER_CTA, _smem_bytes, group_norm,
                                          group_norm_plain, group_norm_plan)
from pww_tpu_torch.ops.layer_norm import MAX_VPT, layer_norm, layer_norm_plain, layer_norm_plan
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)


def _inputs(shape_nhwc, mean=0.0, seed=0):
    rng = np.random.default_rng(seed)
    c = shape_nhwc[-1]
    x = (rng.standard_normal(shape_nhwc) * 2.0 + mean).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    add = rng.standard_normal((shape_nhwc[0], c)).astype(np.float32)
    return x, w, b, add


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _assert_bf16_close(got, want):
    """bf16 outputs computed from f32 statistics taken in another order: an
    element may round the other way, one bf16 ulp (2^-7 of its magnitude at
    most), and an output near 0 (x near the mean) may differ by the f32
    mean's rounding, under 1e-5 of the largest output."""
    tol = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


# (N, H, W, C), groups, whole_row_bytes: the default reaches the whole-row
# kernel; 4 KiB forces the chunked pair, in two chunks of 512 rows.
SCHEMES = {"whole_row": 1536 * 1024, "chunked": 4 * 1024}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("silu,with_add", [(False, False), (True, False), (True, True)])
def test_group_norm_plain_matches_jax_kernel_f32(scheme, silu, with_add):
    """f32 in and out: only the summation order differs (the JAX test of its
    own kernel against flax holds 2e-5)."""
    x, w, b, add = _inputs((2, 32, 32, 32))
    a = add if with_add else None
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=4, eps=1e-5,
                          act="silu" if silu else None,
                          add=None if a is None else jnp.asarray(a),
                          whole_row_bytes=SCHEMES[scheme], force_fused=True)
    got = group_norm(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups=4, eps=1e-5,
                     silu=silu, add=None if a is None else torch.from_numpy(a))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_group_norm_plain_matches_jax_kernel_bf16_with_pre_add(scheme):
    """The ResNet norm2 site: bf16 x and time embedding, SiLU, bf16 out.

    The port rounds x + add to bf16 before the statistics, as the JAX
    kernel's source does (``pww_tpu/ops/group_norm.py:96-100``) and its flax
    reference computes: they agree to one ulp. In interpret mode on the CPU
    the JAX kernel's sum stays f32 (XLA drops the bf16 rounding inside the
    fused add and convert): each input then differs by up to half a bf16 ulp
    of x + add, 30% of the outputs round differently, and the two agree to
    4 bf16 ulps of the largest output (2^-6·max|y|) and 1e-2 in relative L2.
    """
    x, w, b, add = _inputs((2, 32, 32, 32), seed=1)
    xb, ab = jnp.asarray(x, jnp.bfloat16), jnp.asarray(add, jnp.bfloat16)
    kernel = np.asarray(jax_group_norm(
        xb, jnp.asarray(w), jnp.asarray(b), groups=8, eps=1e-5, act="silu", add=ab,
        whole_row_bytes=SCHEMES[scheme], force_fused=True), np.float32)
    flax = np.asarray(_reference_group_norm(
        xb, jnp.asarray(w), jnp.asarray(b), groups=8, eps=1e-5, act="silu", add=ab,
        out_dtype=jnp.bfloat16), np.float32)
    got = group_norm(_nchw(x).to(torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b),
                     groups=8, eps=1e-5, silu=True,
                     add=torch.from_numpy(add).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = np.moveaxis(got.float().numpy(), 1, -1)
    _assert_bf16_close(got, flax)
    assert np.abs(got - kernel).max() <= 2.0 ** -6 * np.abs(kernel).max()
    assert np.linalg.norm(got - kernel) <= 1e-2 * np.linalg.norm(kernel)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_group_norm_plain_matches_jax_kernel_large_mean(scheme):
    """|mean| = 30 ≫ std = 2: E[x²] − μ² cancels about 8 bits of the f32
    statistics, which both sides sum in another order; outputs up to 4.7
    differed by at most 2.1e-4 when this test was written, so 5e-4."""
    x, w, b, _ = _inputs((1, 32, 32, 32), mean=30.0, seed=2)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=4, eps=1e-6,
                          whole_row_bytes=SCHEMES[scheme], force_fused=True)
    got = group_norm(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups=4, eps=1e-6)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [0.0, 30.0])
def test_layer_norm_plain_matches_jax_kernel(dtype, mean):
    """f32: summation order only (2e-5; at |mean| = 30, 5e-4 as for K4,
    measured 1.9e-4);
    bf16 in and out: at most one ulp of rounding the other way."""
    x, w, b, _ = _inputs((2, 64, 48), mean=mean, seed=3)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), eps=1e-5,
                                     force_fused=True), np.float32)
    got = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
                     torch.from_numpy(b), eps=1e-5).float().numpy()
    if dtype == "bfloat16":
        _assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 if mean else 2e-5)


def test_group_norm_out_dtype_and_bf16_params():
    """An f32 result from bf16 input; bf16 weight and bias (the card's
    parameter dtype) give what their f32 values give."""
    x, w, b, _ = _inputs((2, 8, 8, 16), seed=4)
    xt = _nchw(x).to(torch.bfloat16)
    wb, bb = torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    got = group_norm(xt, wb, bb, groups=4, eps=1e-5, out_dtype=torch.float32)
    want = group_norm_plain(xt, wb.float(), bb.float(), groups=4, eps=1e-5,
                            out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_raise_off_the_cpu_and_the_card():
    """A tensor neither on the CPU nor on a CUDA card gets no silent fallback."""
    x = torch.zeros((1, 8, 4, 4), device="meta")
    w = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        group_norm(x, w, w, groups=2, eps=1e-5)
    with pytest.raises(ValueError, match="CUDA kernel"):
        layer_norm(x, w[:4], w[:4], eps=1e-5)
    y = torch.ones((3, 8))
    torch.testing.assert_close(layer_norm(y, torch.ones(8), torch.zeros(8), eps=1e-5),
                               layer_norm_plain(y, torch.ones(8), torch.zeros(8), eps=1e-5))


# ---- the kernels' launch plans (pure Python; the kernels run on the card) ----

K4_SIGNATURES = list(chip_smoke.K4_SITES)
# the VAE's spans at 768² and 1024²: its 512² signatures with H and W scaled
K4_LARGER = sorted({(1, s[0][1], s[0][2] * k // 2, s[0][3] * k // 2)
                    for s in K4_SIGNATURES if s[0][0] == 1 for k in (3, 4)})


def _ceil8(n):
    return (n + 7) // 8 * 8


@pytest.mark.parametrize("shape", [s[0] for s in K4_SIGNATURES] + K4_LARGER,
                         ids=[chip_smoke.k4_label(s) for s in K4_SIGNATURES]
                         + [str(s) for s in K4_LARGER])
def test_group_norm_plan(shape):
    """A cluster of 1-16 CTAs per group span within the card's shared memory;
    resident exactly when some cluster holds the span, so that at 512² only
    (1, 256, 512, 512) streams."""
    n, c = shape[:2]
    cpg = c // 32
    span = cpg * math.prod(shape[2:])
    plan = group_norm_plan(span, cpg, n * 32)
    assert plan.cluster in CLUSTER_SIZES == (1, 2, 4, 8, 16)
    assert plan.piece == _ceil8(-(-span // plan.cluster))
    assert plan.smem_bytes == _smem_bytes(plan.resident, cpg) <= SMEM_PER_CTA == 232_448
    fits = any(_smem_bytes(_ceil8(-(-span // k)), cpg) <= SMEM_PER_CTA for k in CLUSTER_SIZES)
    assert plan.streamed is not fits
    assert plan.resident == (plan.piece if fits else 0)
    assert plan.threads == (512 if 2 * plan.smem_bytes > SMEM_PER_CTA else 256)
    if shape not in K4_LARGER:
        assert plan.streamed is (shape == (1, 256, 512, 512))


def test_group_norm_plan_falls_back_to_smaller_clusters():
    """A card that places clusters of 8 at most streams the 2 MB spans."""
    plan = group_norm_plan(4 * 512 * 512, 4, 32, max_cluster=8)
    assert (plan.cluster, plan.streamed) == (8, True)
    assert group_norm_plan(2560, 40, 64, max_cluster=8).cluster == 1


@pytest.mark.parametrize("c", [320, 640, 768, 1024, 1280, 2048])
@pytest.mark.parametrize("rows", [2 * 4096, 2 * 1024, 2 * 256, 2 * 64])
def test_layer_norm_plan(rows, c):
    """Every lane owns whole 16-byte vectors and none idles; the grid has at
    least a CTA per SM wherever there are as many rows."""
    plan = layer_norm_plan(rows, c)
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and 1 <= plan.vpt <= MAX_VPT
    assert plan.lanes * plan.vpt * 8 == c
    assert plan.threads % plan.lanes == 0 and plan.threads <= 128
    assert plan.threads < 32 or plan.threads % 32 == 0
    if rows >= 132:
        assert plan.grid >= 132
    assert plan.grid * plan.threads // plan.lanes <= rows  # no group without a row


def test_norm_site_tables_match_the_models(monkeypatch):
    """``chip_smoke.py``'s tables are the K4 and K5 calls of SD-1.5-inpainting
    at 512²: one UNet step (CFG batch 2), a VAE encode and a decode, traced
    on the meta device (shapes only, nothing computed)."""
    import dataclasses

    import pww_tpu_torch.models.unet as unet_mod
    from pww_tpu_torch.config import SDModelConfig, UNetConfig, VAEConfig
    from pww_tpu_torch.ops import group_norm as gn
    from pww_tpu_torch.ops import layer_norm as ln
    from pww_tpu_torch.weights.bridge import build_models

    calls = {}

    def gn_rec(x, weight, bias, *, groups, eps, silu=False, add=None, out_dtype=None):
        key = (tuple(x.shape), groups, eps, silu, add is not None)
        calls.setdefault(key, [0, 0, 0])[part] += 1
        return torch.empty_like(x)

    def ln_rec(x, weight, bias, *, eps, out_dtype=None):
        key = (tuple(x.shape), eps)
        calls[key] = calls.get(key, 0) + 1
        return torch.empty_like(x)

    monkeypatch.setattr(gn, "group_norm", gn_rec)
    monkeypatch.setattr(ln, "layer_norm", ln_rec)
    monkeypatch.setattr(unet_mod, "flash_self_attention", lambda q, k, v: torch.empty_like(q))
    cfg = SDModelConfig(
        unet=dataclasses.replace(UNetConfig.sd15_inpaint(), fused_group_norm=True,
                                 fused_layer_norm=True),
        vae=dataclasses.replace(VAEConfig.sd15(), fused_group_norm=True))
    models = build_models(cfg)
    with torch.device("meta"):
        part = 0
        models["unet"](torch.empty(2, 9, 64, 64), torch.tensor(1.0), torch.empty(2, 77, 768))
        part = 1
        models["vae"].encode_moments(torch.empty(1, 3, 512, 512))
        part = 2
        models["vae"].decode(torch.empty(1, 4, 64, 64))
    assert {k: tuple(v) for k, v in calls.items() if len(k) == 5} == chip_smoke.K4_SITES
    assert {k: v for k, v in calls.items() if len(k) == 2} == chip_smoke.K5_SITES
    assert [sum(v[i] for v in chip_smoke.K4_SITES.values()) for i in range(3)] == [61, 22, 30]
    assert sum(chip_smoke.K5_SITES.values()) == 48
