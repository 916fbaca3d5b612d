"""The port's utilities against the JAX package's: the phase timer, tracing
and NaN checks (pww_tpu_torch/utils/profiling.py), LPIPS
(pww_tpu_torch/metrics/lpips.py) and the native host library
(pww_tpu_torch/native) against its numpy versions and pww_tpu.native."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pww_tpu import native as jax_native
from pww_tpu.metrics import lpips as jax_lpips
from pww_tpu_torch import native
from pww_tpu_torch.metrics import lpips
from pww_tpu_torch.native import plain
from pww_tpu_torch.utils.profiling import PhaseTimer, enable_nan_checks, trace
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)


# -- profiling (tests/test_profiling.py) ------------------------------------------

def test_phase_timer_aggregation():
    t = PhaseTimer()
    for s in (0.1, 0.3, 0.2):
        t.record("denoise", s)
    assert t.p50("denoise") == pytest.approx(0.2)
    assert t.total("denoise") == pytest.approx(0.6)
    # throughput derives from the p50, not the mean (robust to a straggler)
    assert t.images_per_sec("denoise", images_per_call=4) == pytest.approx(20.0)
    s = t.summary()["denoise"]
    assert s["count"] == 3 and s["p50_s"] == pytest.approx(0.2)
    # unknown phases: None / 0.0, never KeyError
    assert t.p50("nope") is None
    assert t.total("nope") == 0.0
    assert t.images_per_sec("nope") is None


def test_phase_context_syncs_device_value():
    t = PhaseTimer()
    with t.phase("encode", sync=torch.ones((4,)) * 2):
        pass
    with t.phase("encode", sync={"a": [torch.zeros(2)]}):
        pass
    assert len(t.times["encode"]) == 2
    assert min(t.times["encode"]) >= 0.0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d) as log_dir:
        (torch.arange(8.0) * 3).sum()
    assert log_dir == d
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_enable_nan_checks_names_the_module():
    net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())
    x = torch.tensor([[float("nan"), 1.0]])
    try:
        enable_nan_checks(True)
        with pytest.raises(FloatingPointError, match="Linear"):
            net(x)
        net(torch.ones(1, 2))  # finite: no error
    finally:
        enable_nan_checks(False)
    assert torch.isnan(net(x)).any()  # off again


def test_pipeline_keeps_timers_and_timings():
    """``profile=True``: the last call's seconds in ``timings``, every call's
    in ``timers`` (``pww_tpu/pipeline/pipeline.py:663-666``)."""
    from pww_tpu_torch.config import SDModelConfig
    from pww_tpu_torch.pipeline.pipeline import PwwPipeline

    pipe = PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, profile=True)
    cm = np.zeros((64, 64, 3), np.uint8)
    cm[:, :32] = (255, 0, 0)
    for _ in range(2):
        pipe.generate(prompt="a cat", color_map_image=cm, color_context={(255, 0, 0): "cat,1"},
                      num_inference_steps=1, output_type="np")
    assert set(pipe.timings) == {"encode", "denoise", "decode"}
    assert pipe.timers.summary()["denoise"]["count"] == 2
    assert pipe.timers.times["decode"][-1] == pipe.timings["decode"]


# -- LPIPS (tests/test_lpips.py) ------------------------------------------------------

def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def test_lpips_matches_the_jax_package():
    """``init_random_lpips`` draws the same numbers (HWIO → OIHW), and the
    distance agrees with pww_tpu.metrics.lpips to 1e-5 relative; the torch
    state-dict loader matches JAX's on the same state."""
    a, b = _pair(1, (2, 64, 64, 3))
    jp = jax_lpips.init_random_lpips(0)
    want = np.asarray(jax_lpips.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b)))
    params = lpips.init_random_lpips(0, device="cpu")
    np.testing.assert_array_equal(params["conv1_w"].numpy(),
                                  np.asarray(jp["conv1_w"]).transpose(3, 2, 0, 1))
    got = lpips.lpips_distance(params, a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)

    alexnet = {f"features.{j}.weight": params[f"conv{i}_w"] * 1.5
               for i, j in enumerate((0, 3, 6, 8, 10))}
    alexnet.update({f"features.{j}.bias": params[f"conv{i}_b"]
                    for i, j in enumerate((0, 3, 6, 8, 10))})
    lins = {f"lins.{i}.model.1.weight": params[f"lin{i}_w"].view(1, -1, 1, 1)
            for i in range(5)}
    got = lpips.lpips_distance(lpips.load_lpips_from_torch_state(alexnet, lins, "cpu"),
                               torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_lpips.lpips_distance(
        jax_lpips.load_lpips_from_torch_state(alexnet, lins), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_identity_is_zero_and_symmetric():
    params = lpips.init_random_lpips(0, device="cpu")
    a, b = _pair(2, (1, 64, 64, 3))
    assert float(lpips.lpips_distance(params, a, a)[0]) == pytest.approx(0.0, abs=1e-6)
    d_ab = float(lpips.lpips_distance(params, a, b)[0])
    d_ba = float(lpips.lpips_distance(params, b, a)[0])
    assert d_ab == pytest.approx(d_ba, rel=1e-5)
    assert d_ab > 0


def test_lpips_nonstandard_size_and_files(tmp_path):
    params = lpips.init_random_lpips(0, device="cpu")
    a, b = _pair(3, (1, 96, 128, 3))
    d = lpips.lpips_distance(params, a, b)
    assert d.shape == (1,) and np.isfinite(float(d[0]))
    alexnet = {f"features.{j}.{leaf}": params[f"conv{i}_{leaf[0]}"]
               for i, j in enumerate((0, 3, 6, 8, 10)) for leaf in ("weight", "bias")}
    lins = {f"lin{i}.model.1.weight": params[f"lin{i}_w"].view(1, -1, 1, 1) for i in range(5)}
    torch.save(alexnet, tmp_path / "alex.pth")
    torch.save(lins, tmp_path / "lin.pth")
    loaded = lpips.load_lpips_from_files(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"),
                                         device="cpu")
    assert float(lpips.lpips_distance(loaded, a, b)[0]) == float(d[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lpips.init_random_lpips(0)


# -- the native host library (tests/test_native.py) ------------------------------

def _img(rng, h=64, w=96):
    img = np.zeros((h, w, 3), np.uint8)
    img[:32] = (255, 0, 0)
    img[32:] = (0, 0, 255)
    img[:4, :4] = (9, 9, 9)
    img[-8:, -8:] = rng.integers(0, 255, (8, 8, 3), np.uint8)
    return img


def test_library_builds():
    assert native.load() is native.load()
    assert os.path.exists(native.SO)
    assert os.path.getmtime(native.SO) >= os.path.getmtime(native.SRC)


def test_color_masks_match_numpy_and_the_jax_package(rng):
    img = _img(rng)
    colors = np.array([(255, 0, 0), (0, 0, 255), (1, 2, 3)], np.uint8)
    strengths = np.array([0.5, 2.0, 1.0], np.float32)
    got, counts = native.color_masks(img, colors, strengths)
    for want, want_counts in (plain.color_masks(img, colors, strengths),
                              jax_native.color_masks(img, colors, strengths)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(counts, want_counts)
    assert counts[2] == 0  # absent color


def test_color_mask_sqdist_matches_numpy(rng):
    img = _img(rng)
    img[10, 10] = (252, 2, 1)  # sq-dist 9+4+1=14 < 30
    got = native.color_mask_sqdist(img, (255, 0, 0), 30)
    np.testing.assert_array_equal(got, plain.color_mask_sqdist(img, (255, 0, 0), 30))
    np.testing.assert_array_equal(got, jax_native.color_mask_sqdist(img, (255, 0, 0), 30))
    assert got[10, 10] and got.dtype == bool


def test_unique_colors_ordering(rng):
    img = _img(rng)
    res = native.unique_colors(img, min_fraction=0.01, max_out=8)
    assert res == plain.unique_colors(img, 0.01, 8) == jax_native.unique_colors(img, 0.01, 8)
    # red: 32*96-16 px, blue: 32*96-64 px -> red first
    assert [c for c, _ in res] == [(255, 0, 0), (0, 0, 255)]
    assert res[0][1] > res[1][1]


def test_token_match_row_overlap():
    row, hits = native.token_match_row([5, 5, 5, 1], [5, 5])
    np.testing.assert_array_equal(row, [1, 2, 1, 0])
    assert hits == 2
    for ids, sub in (([5, 5, 5, 1], [5, 5]), ([3, 4, 3, 4, 3], [3, 4, 3]), ([1, 2], [])):
        got, want = native.token_match_row(ids, sub), plain.token_match_row(ids, sub)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == jax_native.token_match_row(ids, sub)[1]


def test_token_match_row_absent():
    row, hits = native.token_match_row([1, 2, 3], [9])
    assert hits == 0 and row.sum() == 0


def test_a_failed_build_raises_with_the_compilers_message(tmp_path):
    """No silent fallback: a source that does not compile, or a compiler
    that is not there, raises."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(str(src), str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build(str(src), str(tmp_path / "lib.so"), compiler=str(tmp_path / "no-cc"))
    assert not os.path.exists(tmp_path / "lib.so")
