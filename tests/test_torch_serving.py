"""The port's serving layer: the Batcher, the HTTP server and the
resolution buckets, on the port's tiny CPU pipeline (f32); the copied
pure-Python parts (``compat_key``, ``_is_singleton``, ``snap_resolution``)
against the JAX package's."""
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from pww_tpu.ops.weight_functions import WeightFunction as JWeightFunction
from pww_tpu.serving import batcher as jbatcher
from pww_tpu.tokenizer.clip_bpe import toy_tokenizer as jax_toy_tokenizer
from pww_tpu.utils import buckets as jbuckets
from pww_tpu_torch.config import SDModelConfig
from pww_tpu_torch.ops.weight_functions import WeightFunction
from pww_tpu_torch.pipeline.pipeline import PwwPipeline
from pww_tpu_torch.serving import batcher as tbatcher
from pww_tpu_torch.serving.batcher import Batcher, _Launch, _Pending, compat_key
from pww_tpu_torch.serving.server import make_handler, request_from_json
from pww_tpu_torch.tokenizer.clip_bpe import toy_tokenizer
from pww_tpu_torch.utils import buckets as tbuckets
from torch_port_cases import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pipe():
    return PwwPipeline(SDModelConfig.tiny(), device="cpu", dtype=torch.float32, seed=11)


def _req(prompt, seed, size=64, **extra):
    cm = np.zeros((size, size, 3), np.uint8)
    cm[:, : size // 2] = (255, 0, 0)
    return dict(prompt=prompt, color_map_image=cm, seed=seed, num_inference_steps=2,
                color_context={(255, 0, 0): f"{prompt.split()[-1]},1.0"}, **extra)


def _direct(pipe, reqs):
    return pipe.generate_batch(reqs, num_inference_steps=2, output_type="np")


def _proxy(pipe, **overrides):
    """The pipeline's attributes on another object, some replaced."""
    proxy = type("P", (), {})()
    for name in dir(pipe):
        if not name.startswith("__"):
            setattr(proxy, name, getattr(pipe, name))
    for name, value in overrides.items():
        setattr(proxy, name, value)
    return proxy


# -- the copied pure-Python parts --------------------------------------------------------

_INIT = np.zeros((100, 90, 3), np.uint8)
KEY_CASES = {
    "txt2img 64": _req("a cat", 0),
    "txt2img 128": _req("a cat", 0, 128),
    "no map": dict(prompt="x", num_inference_steps=3),
    "img2img": dict(_req("a cat", 0), init_image=_INIT, strength=0.7),
    "inpaint": dict(_req("a cat", 0), init_image=_INIT, mask_image=np.zeros((100, 90))),
    "weight function": dict(_req("a cat", 0), weight_function="wf"),
    "options": dict(_req("a cat", 0), guidance_scale=5.0, cache_interval=2, tome_ratio=0.3,
                    freeu=(1.5, 1.6, 0.9, 0.2), sag_scale=0.4),
    "long prompt": dict(_req("a " + "word " * 100 + "cat", 0), long_prompts=True),
    "long prompt, long negative": dict(_req("a cat", 0), long_prompts=True,
                                       negative_prompt="word " * 160),
    "singleton: prompt editing": dict(_req("a cat", 0), prompt_editing=True),
    "singleton: full-res inpaint": dict(_req("a cat", 0), inpaint_full_res=True),
    "singleton: ControlNet": dict(_req("a cat", 0), control_image=_INIT),
    "singleton: IP-Adapter": dict(_req("a cat", 0), ip_adapter_image=_INIT),
    "singleton: T2I-Adapter": dict(_req("a cat", 0), adapter_image=_INIT),
    "singleton: samples": dict(_req("a cat", 0), num_samples=2),
    "singleton: ensemble end": dict(_req("a cat", 0), denoising_end=0.8),
    "singleton: ensemble start": dict(_req("a cat", 0), denoising_start=0.8),
    "singleton: original size": dict(_req("a cat", 0), original_size=(64, 64)),
    "singleton: target size": dict(_req("a cat", 0), target_size=(64, 64)),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_compat_key_and_singleton_match_jax(case):
    """Equal keys, the default noise mode ("jax") included."""
    req = dict(KEY_CASES[case])
    jreq = dict(req, weight_function=JWeightFunction(0.3)) if "weight" in case else req
    if "weight" in case:
        req = dict(req, weight_function=WeightFunction(0.3))
    assert tbatcher._is_singleton(req) == jbatcher._is_singleton(jreq)
    key = compat_key(req, toy_tokenizer(1000))
    want = jbatcher.compat_key(jreq, jax_toy_tokenizer(1000))
    if tbatcher._is_singleton(req):
        assert key[0] == want[0] == "singleton"
        assert key != compat_key(req)  # a singleton matches nothing
    else:
        assert key == want
        assert compat_key(KEY_CASES[case])[-1][-1] == "jax"  # both packages' default


@pytest.mark.parametrize("w,h", [(64, 64), (500, 300), (100, 2000), (1023, 257), (0, 0),
                                 (767, 769), (96, 160)])
def test_snap_resolution_matches_jax(w, h):
    assert tbuckets.snap_resolution(w, h) == jbuckets.snap_resolution(w, h)
    assert tbuckets.snap_resolution(w, h, 32, 64, 512) == jbuckets.snap_resolution(
        w, h, 32, 64, 512)
    assert tbuckets.bucket_count() == jbuckets.bucket_count() == 169


# -- the Batcher ---------------------------------------------------------------------------

def test_batcher_fuses_concurrent_requests(pipe):
    reqs = [_req(p, i) for i, p in enumerate(["a cat", "a dog", "a fox"])]
    b = Batcher(pipe, max_batch=4, max_wait_ms=300.0)
    try:
        imgs = [f.result(timeout=120) for f in [b.submit(dict(r)) for r in reqs]]
    finally:
        b.close()
    assert b.stats["requests"] == 3 and b.stats["batches"] < 3
    if b.stats["batches"] == 1:  # one group of 3: the same call as the direct one
        for img, row in zip(imgs, _direct(pipe, reqs)):
            np.testing.assert_array_equal(np.asarray(img), row)
    assert all(im.size == (64, 64) for im in imgs)


def test_batcher_separates_incompatible_keys(pipe):
    b = Batcher(pipe, max_batch=4, max_wait_ms=300.0)
    try:
        futs = [b.submit(_req("a cat", 0)), b.submit(_req("a dog", 1, 128)),
                b.submit(dict(_req("a fox", 2), num_inference_steps=3))]
        imgs = [f.result(timeout=120) for f in futs]
    finally:
        b.close()
    assert b.stats["batches"] == 3 and [im.size for im in imgs] == [(64, 64), (128, 128),
                                                                    (64, 64)]


def test_batcher_propagates_errors(pipe):
    b = Batcher(pipe, max_batch=2, max_wait_ms=10.0)
    try:
        bad = dict(_req("x", 0), color_map_image="not-an-image")
        with pytest.raises(Exception):
            b.submit(bad).result(timeout=60)
        assert b.submit(_req("a cat", 0)).result(timeout=60).size == (64, 64)  # still serving
    finally:
        b.close()


def test_batcher_metrics(pipe):
    b = Batcher(pipe, max_batch=2, max_wait_ms=200.0)
    try:
        assert b.metrics()["batch_efficiency"] is None
        futs = [b.submit(_req(p, i)) for i, p in enumerate(["a cat", "a dog"])]
        for f in futs:
            f.result(timeout=120)
        for s in (0.5, 1.0, 2.0):
            b.observe_latency(s)
    finally:
        b.close()
    m = b.metrics()
    assert m["requests"] == 2 and m["latency_samples"] == 3
    assert m["batch_efficiency"] == 2 / m["batches"]
    assert m["latency_p50_s"] == 1.0 and m["latency_p95_s"] == 2.0


def test_batcher_max_batch_pixels_caps_group(pipe):
    b = Batcher(pipe, max_batch=4, max_wait_ms=300.0, max_batch_pixels=2 * 64 * 64)
    try:
        assert b._cap_for(((64, 64),)) == 2
        assert b._cap_for(((128, 128),)) == 1  # never 0
        assert b._cap_for(("singleton", object())) == 4
        futs = [b.submit(_req(p, i)) for i, p in enumerate(["a cat", "a dog", "a fox", "a owl"])]
        imgs = [f.result(timeout=120) for f in futs]
    finally:
        b.close()
    assert b.stats["batches"] == 2 and b.stats["batched_requests"] == 4
    assert all(im.size == (64, 64) for im in imgs)


def test_batcher_retries_failed_launch(pipe):
    """A launch that fails once (out of memory under overlapped work) is
    retried whole after the drain; the clients get their images."""
    real, calls = pipe.generate_batch, []

    def flaky(reqs, **kw):
        calls.append(kw["output_type"])
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(reqs, **kw)

    reqs = [_req("a cat", 0), _req("a dog", 1)]
    b = Batcher(_proxy(pipe, generate_batch=flaky), max_batch=4, max_wait_ms=300.0)
    try:
        imgs = [f.result(timeout=120) for f in [b.submit(dict(r)) for r in reqs]]
    finally:
        b.close()
    assert b.stats["retries"] == 1 and calls == ["device", "np"]
    for img, row in zip(imgs, _direct(pipe, reqs)):
        np.testing.assert_array_equal(np.asarray(img), row)


def test_batcher_requeues_failed_fetch_once(pipe):
    """A launched group whose copy to the host fails is requeued once and
    relaunched; the second failure of a request is real."""

    class FlakyImages:
        def __init__(self, arr, fails):
            self.arr, self.fails = np.asarray(arr), fails

        def __array__(self, dtype=None, copy=None):
            if self.fails:
                self.fails -= 1
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return self.arr

    real, calls = pipe.generate_batch, []

    def wrapped(reqs, **kw):
        calls.append(len(reqs))
        return FlakyImages(real(reqs, **{**kw, "output_type": "np"}), len(calls) == 1)

    reqs = [_req("a cat", 0), _req("a dog", 1)]
    b = Batcher(_proxy(pipe, generate_batch=wrapped), max_batch=4, max_wait_ms=300.0)
    try:
        imgs = [f.result(timeout=120) for f in [b.submit(dict(r)) for r in reqs]]
    finally:
        b.close()
    assert b.stats["retries"] == 1 and calls == [2, 2]
    for img, row in zip(imgs, _direct(pipe, reqs)):
        np.testing.assert_array_equal(np.asarray(img), row)

    def always(reqs, **kw):
        return FlakyImages(real(reqs, **{**kw, "output_type": "np"}), 2)

    b = Batcher(_proxy(pipe, generate_batch=always), max_batch=4, max_wait_ms=10.0)
    try:
        with pytest.raises(RuntimeError, match="illegal memory"):
            b.submit(_req("a cat", 0)).result(timeout=120)
    finally:
        b.close()


def test_backpressure_releases_at_compute_not_fetch(pipe):
    """The busy window ends at the compute barrier, while the copy to the
    host is still running."""
    gate = threading.Event()

    class BlockedCopy:
        def __array__(self, dtype=None, copy=None):
            assert gate.wait(timeout=10.0)
            return np.zeros((1, 8, 8, 3), np.uint8)

    b = Batcher(pipe, max_batch=2, max_wait_ms=10.0)
    try:
        p = _Pending(request={}, key=("k",))
        b._hand_to_fetcher([p], _Launch(BlockedCopy()))
        deadline = time.monotonic() + 5.0
        while b._computing > 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert b._computing == 0 and not p.future.done()
        gate.set()
        assert p.future.result(timeout=10.0).size == (8, 8)
    finally:
        gate.set()
        b.close()


def test_singletons_go_through_generate(pipe):
    """Two samples run through ``generate`` alone (its first image); a
    full-res inpaint, which refuses device output, through a synchronous
    call; a prompt-editing request, which refuses device output too, the
    same way; an IP-Adapter image on a pipeline without an adapter resolves
    to generate's ValueError (tests/test_torch_ip_adapter.py serves one
    with an adapter attached)."""
    init = np.full((64, 64, 3), 120, np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    cases = [dict(_req("a cat", 3), num_samples=2),
             dict(_req("a cat", 4), init_image=init, mask_image=mask, inpaint_full_res=True),
             dict(_req("a cat", 5), prompt="a [cat:fox:0.5]", prompt_editing=True),
             dict(_req("a cat", 6), ip_adapter_image=init)]
    b = Batcher(pipe, max_batch=4, max_wait_ms=300.0)
    try:
        futs = [b.submit(dict(r)) for r in cases]
        two = futs[0].result(timeout=120)
        full_res = futs[1].result(timeout=120)
        edited = futs[2].result(timeout=120)
        with pytest.raises(ValueError, match="load_ip_adapter"):
            futs[3].result(timeout=120)
    finally:
        b.close()
    assert b.stats["batches"] == 4
    kw = {k: v for k, v in cases[0].items()}
    np.testing.assert_array_equal(np.asarray(two), pipe.generate(**kw, output_type="np")[0])
    np.testing.assert_array_equal(np.asarray(full_res),
                                  pipe.generate(**cases[1], output_type="np")[0])
    np.testing.assert_array_equal(np.asarray(edited),
                                  pipe.generate(**cases[2], output_type="np")[0])


# -- the server ------------------------------------------------------------------------------

def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_server_round_trip(pipe):
    """POST /generate through the Batcher equals the same request through
    ``generate``; a request with ToMe runs; /healthz, /metrics, an unknown
    path and an IP-Adapter image on a pipeline without an adapter (500
    with the pipeline's ValueError; tests/test_torch_ip_adapter.py serves
    one with an adapter attached)."""
    from PIL import Image

    cm = np.zeros((256, 256, 3), np.uint8)
    cm[:, :128] = (255, 0, 0)
    body = {"prompt": "a cat", "seed": 3, "steps": 2, "color_context": {"(255, 0, 0)": "cat,1.0"},
            "color_map_png_b64": _png_b64(cm)}
    req = request_from_json(body)
    assert req["color_context"] == {(255, 0, 0): "cat,1.0"} and req["cache_interval"] == 1
    b = Batcher(pipe, max_batch=4, max_wait_ms=10.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(b))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(payload):
        r = urllib.request.Request(f"{url}/generate", data=json.dumps(payload).encode(),
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        out = post(body)
        tome = post(dict(body, tome_ratio=0.5))
        with pytest.raises(urllib.error.HTTPError) as err:
            post(dict(body, ip_adapter_image_png_b64=_png_b64(cm)))
        assert (err.value.code == 500
                and "load_ip_adapter" in json.loads(err.value.read())["error"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/nowhere", timeout=60)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        b.close()
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"]))))
    want = pipe.generate(prompt="a cat", color_map_image=cm, color_context={(255, 0, 0): "cat,1.0"},
                         seed=3, num_inference_steps=2, output_type="np")[0]
    np.testing.assert_array_equal(got, want)
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(tome["image_png_b64"]))))
    np.testing.assert_array_equal(got, pipe.generate(
        prompt="a cat", color_map_image=cm, color_context={(255, 0, 0): "cat,1.0"}, seed=3,
        num_inference_steps=2, tome_ratio=0.5, output_type="np")[0])
    assert health["ok"] and health["stats"]["requests"] == 3
    assert metrics["latency_samples"] == 2 and out["latency_s"] >= 0


def test_server_snaps_sizes(pipe):
    """The map to the 64 lattice (nearest), an init off the lattice onto it,
    the mask to the init's size."""
    cm = np.zeros((300, 200, 3), np.uint8)
    init = np.zeros((130, 260, 3), np.uint8)
    req = request_from_json({"color_map_png_b64": _png_b64(cm), "init_image_png_b64":
                             _png_b64(init), "mask_image_png_b64": _png_b64(
                                 np.full((10, 10, 3), 255, np.uint8))})
    assert req["color_map_image"].shape == (320, 256, 3)
    assert req["init_image"].shape == (256, 256, 3)
    assert req["mask_image"].shape == (256, 256) and req["mask_image"].max() == 1.0
    aligned = request_from_json({"init_image_png_b64": _png_b64(np.zeros((128, 192, 3), np.uint8))})
    assert aligned["init_image"].shape == (128, 192, 3)


def test_main_builds_on_the_card_unless_told(monkeypatch):
    """``main()`` serves a pipeline on the card by default; ``--device cpu``
    asks for the CPU (the server itself is not started here)."""
    from pww_tpu_torch.serving import server

    seen = {}

    class Stop(Exception):
        pass

    def build(model, tiny, device):
        seen.update(model=model, tiny=tiny, device=device)
        raise Stop

    real = server.build_pipeline
    monkeypatch.setattr(server, "build_pipeline", build)
    with pytest.raises(Stop):
        server.main(["--tiny"])
    assert seen == {"model": None, "tiny": True, "device": "cuda"}
    with pytest.raises(Stop):
        server.main(["--tiny", "--device", "cpu"])
    assert seen["device"] == "cpu"
    monkeypatch.setattr(server, "build_pipeline", real)
    monkeypatch.setattr(server, "build_pipeline", lambda *a: "pipe")

    def batcher(pipe, **kw):
        seen.update(pipe=pipe, **kw)
        raise Stop

    monkeypatch.setattr(server, "Batcher", batcher)
    with pytest.raises(Stop):
        server.main(["--tiny", "--max-batch", "4", "--max-wait-ms", "10",
                     "--max-batch-pixels", str(2 * 512 * 512)])
    assert (seen["pipe"], seen["max_batch"], seen["max_wait_ms"],
            seen["max_batch_pixels"]) == ("pipe", 4, 10.0, 2 * 512 * 512)
    with pytest.raises(Stop):
        server.main(["--tiny"])
    assert (seen["max_batch"], seen["max_wait_ms"], seen["max_batch_pixels"]) == (8, 25.0, None)
    monkeypatch.setattr(server, "build_pipeline", real)
    p = server.build_pipeline(tiny=True, device="cpu")
    assert p.device.type == "cpu" and p.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            server.build_pipeline(tiny=True)
