"""The port's attention ops against the JAX package's, on the CPU in f32.

K1-K3's plain PyTorch versions (what the port's wrappers run for CPU
tensors) are held against the JAX package's Pallas kernels, which run here
in Pallas interpret mode as the package's own tests run them, at shapes
that tile in JAX (Lq 512 with 256-row blocks). The kernels themselves run
only on the card; ``chip_smoke.py`` holds them against these plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu.ops import attention as jattn
from pww_tpu.ops import cross_attention_kernel as jxk
from pww_tpu.ops import flash_attention as jfa
from pww_tpu.ops.weight_functions import CustomWeightFunction as JCustom
from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu_torch.ops import attention as tattn
from pww_tpu_torch.ops import cross_attention_kernel as txk
from pww_tpu_torch.ops import flash_attention as tfa
from pww_tpu_torch.ops.weight_functions import CustomWeightFunction, WeightFunction
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)

# f32 on both sides; the two differ only in summation order, so the bound
# is a few f32 ulps of the O(10) scores, amplified a little by the softmax.
ATOL, RTOL = 2e-5, 2e-5


def _qkv(seed, b=2, h=2, lq=512, lk=77, dh=40, mean=0.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32) + mean
    k = rng.standard_normal((b, h, lk, dh)).astype(np.float32) + mean
    v = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    w = np.zeros((b, lq, lk), np.float32)
    w[1:] = rng.random((b - 1, lq, lk))  # row 0 = uncond (zero weights)
    return q, k, v, w


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("dh", [40, 80])
@pytest.mark.parametrize("mode", ["max", "mean", "std", "one"])
def test_reduce_plain_matches_jax_kernel(mode, dh):
    q, k, _, _ = _qkv(1, dh=dh)
    want = np.asarray(jxk.fused_pww_reduce(
        jnp.asarray(q), jnp.asarray(k), JWeightFunction(0.1, "log1p_sigma", mode),
        block_q=256))
    got = txk.fused_pww_reduce(*_t(q, k), WeightFunction(0.1, "log1p_sigma", mode))
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_reduce_std_large_mean_matches_jax_kernel():
    """|mean| ≫ std: the naive Σx² − (Σx)²/n formula would cancel here;
    both sides must still agree on the unbiased std (mirrors
    test_cross_attention_kernel.py::test_pallas_reduce_std_large_mean_stability)."""
    q, k, _, _ = _qkv(2, mean=6.0)
    wf = JWeightFunction(0.3, "log1p_sigma", "std")
    want = np.asarray(jxk.fused_pww_reduce(jnp.asarray(q), jnp.asarray(k), wf,
                                           block_q=256))
    got = txk.fused_pww_reduce(*_t(q, k), WeightFunction(0.3, "log1p_sigma", "std"))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    exact = s.reshape(2, -1).std(axis=1, ddof=1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("dh", [40, 80])
@pytest.mark.parametrize("mode", ["max", "std"])
def test_cross_attention_plain_matches_jax_kernel(mode, dh):
    q, k, v, w = _qkv(3, dh=dh)
    jwf = JWeightFunction(0.3, "log1p_sigma", mode)
    sigma = 4.0
    coef = np.asarray(jwf.sigma_coef(jnp.float32(sigma)) * jxk.fused_pww_reduce(
        jnp.asarray(q), jnp.asarray(k), jwf, block_q=256))
    want = np.asarray(jxk.fused_pww_cross_attention(
        *(jnp.asarray(x) for x in (q, k, v, w)), jnp.asarray(coef), block_q=256))
    got = txk.fused_pww_cross_attention(*_t(q, k, v, w, coef))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the uncond row (w = 0) is plain attention
    plain = tfa.self_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dh", [40, 80])
def test_flash_plain_matches_jax_kernel(dh):
    q, _, _, _ = _qkv(4, dh=dh)
    rng = np.random.default_rng(5)
    k = rng.standard_normal(q.shape).astype(np.float32)
    v = rng.standard_normal(q.shape).astype(np.float32)
    want = np.asarray(jfa.flash_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block=256, pad_heads=False))
    got = tfa.flash_self_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_wrappers_on_cpu_take_the_plain_path_and_count_nothing():
    q, k, v, w = _t(*_qkv(6, lq=64))
    coef = torch.tensor([0.0, 0.5])
    before = (txk.fused_pww_reduce.launches, txk.fused_pww_cross_attention.launches,
              tfa.flash_self_attention.launches)
    wf = WeightFunction()
    torch.testing.assert_close(txk.fused_pww_reduce(q, k, wf),
                               txk.pww_cross_attention_reduce(q, k, wf))
    torch.testing.assert_close(txk.fused_pww_cross_attention(q, k, v, w, coef),
                               txk.pww_cross_attention_plain(q, k, v, w, coef))
    torch.testing.assert_close(tfa.flash_self_attention(q, q, q),
                               tfa.self_attention_plain(q, q, q))
    after = (txk.fused_pww_reduce.launches, txk.fused_pww_cross_attention.launches,
             tfa.flash_self_attention.launches)
    assert after == before == (0, 0, 0)


@pytest.mark.parametrize("op", ["reduce", "xattn", "flash"])
def test_wrappers_refuse_tensors_they_have_no_kernel_for(op):
    """Neither the CPU nor the card: no silent fallback, an error."""
    q = torch.empty((2, 2, 64, 40), device="meta")
    with pytest.raises(ValueError):
        if op == "reduce":
            txk.fused_pww_reduce(q, q, WeightFunction())
        elif op == "xattn":
            txk.fused_pww_cross_attention(q, q, q, torch.empty((2, 64, 64), device="meta"),
                                          torch.empty((2,), device="meta"))
        else:
            tfa.flash_self_attention(q, q, q)


@pytest.mark.parametrize("mode", ["max", "std", "mean", "one"])
def test_dense_pww_attention_with_bias_matches_jax(mode):
    q, k, v, w = _qkv(7, lq=64, dh=16)
    sigma = 3.0
    want = np.asarray(jattn.pww_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias_w=jnp.asarray(w),
        weight_fn=JWeightFunction(0.2, "log1p_sigma2", mode), sigma=jnp.float32(sigma)))
    got = tattn.pww_attention(*_t(q, k, v), bias_w=torch.from_numpy(w),
                              weight_fn=WeightFunction(0.2, "log1p_sigma2", mode),
                              sigma=torch.tensor(sigma))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_dense_pww_attention_custom_weight_function_matches_jax():
    """A custom callable sees each sample's own (H, Lq, Lk) scores."""
    q, k, v, w = _qkv(8, lq=64, dh=16)
    want = np.asarray(jattn.pww_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias_w=jnp.asarray(w),
        weight_fn=JCustom(lambda w_, s_, qk: 0.4 * w_ * jnp.log1p(s_) * qk.max()),
        sigma=jnp.float32(2.0)))
    got = tattn.pww_attention(
        *_t(q, k, v), bias_w=torch.from_numpy(w),
        weight_fn=CustomWeightFunction(lambda w_, s_, qk: 0.4 * w_ * torch.log1p(s_) * qk.max()),
        sigma=torch.tensor(2.0))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_dense_causal_attention_matches_jax():
    q, k, v, _ = _qkv(9, lq=77, dh=8)
    want = np.asarray(jattn.pww_attention(*(jnp.asarray(x) for x in (q, q, v)), causal=True))
    got = tattn.pww_attention(*_t(q, q, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the first query sees only the first key
    np.testing.assert_allclose(got[:, :, 0].numpy(), v[:, :, 0], atol=1e-6)


def test_split_and_merge_heads_match_jax():
    x = np.random.default_rng(10).standard_normal((2, 12, 32)).astype(np.float32)
    s = tattn.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 4)))
    assert s.is_contiguous()
    np.testing.assert_array_equal(tattn.merge_heads(s).numpy(), x)


@pytest.mark.parametrize("sigma_mode", ["log1p_sigma", "log1p_sigma2", "one"])
def test_weight_function_sigma_coef_matches_jax(sigma_mode):
    for sigma in (0.0, 0.7, 14.6):
        want = np.asarray(JWeightFunction(0.3, sigma_mode, "max").sigma_coef(sigma))
        got = WeightFunction(0.3, sigma_mode, "max").sigma_coef(torch.tensor(sigma))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
