"""Standard-library HTTP server over the request Batcher.

Port of :mod:`pww_tpu.serving.server`::

    POST /generate  {"prompt": ..., "color_context": {"#ff0000": "cat,1.0"},
                     "color_map_png_b64": ..., "seed": 0, "steps": 30,
                     "guidance_scale": 7.5, "negative_prompt": "",
                     "weight_function": {"scale": 0.4, "sigma_mode":
                         "log1p_sigma", "reduce_mode": "max"},   # optional
                     "prompt_weighting": false, "clip_skip": 0,
                     "long_prompts": false,
                     "init_image_png_b64": ...,    # optional: img2img
                     "strength": 0.5,
                     "mask_image_png_b64": ...,    # optional: inpaint (with init)
                     "mask_blur": 0.0, "masked_content": "original",
                     "ip_adapter_image_png_b64": ...}  # optional: an IP-Adapter's
                                                       # reference image
      → {"image_png_b64": ..., "latency_s": ...}
    GET  /healthz   → {"ok": true, "stats": {...}}
    GET  /metrics   → counters, p50/p95 request latency, batch efficiency

Run: ``python -m pww_tpu_torch.serving.server [--model DIR | --tiny]
[--device cpu] [--port 8000]``. The pipeline is built once, on the card
unless ``--device cpu`` is given; concurrent compatible requests are fused
by :mod:`pww_tpu_torch.serving.batcher`. The sampling extras
(``cache_interval``, ``tome_ratio``, ``freeu``, ``sag_scale``, and
``prompt_editing``, which runs alone) are passed on. An
``ip_adapter_image_png_b64`` runs alone through ``generate`` with the
pipeline's IP-Adapter (``make_handler(Batcher(pipe))`` on a pipeline
that ``load_ip_adapter`` attached one to); without one it answers 500
with the pipeline's ``ValueError``, as any refusal of the pipeline does.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import Batcher


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _encode_image(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _parse_context(ctx: dict) -> dict:
    """JSON keys: "#rrggbb" as they are, "(r, g, b)" → a tuple."""
    out = {}
    for k, v in ctx.items():
        if isinstance(k, str) and not k.startswith("#"):
            k = tuple(int(x) for x in k.strip("()").split(","))
        out[k] = v
    return out


def _resize(arr: np.ndarray, w: int, h: int, resample) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize((w, h), resample))


def request_from_json(req: dict) -> dict:
    """A ``POST /generate`` body → a Batcher request dict: the color map
    snapped to the bucket lattice (nearest), an init image off the 64
    lattice resized onto it (bilinear), the mask to the init's size."""
    from PIL import Image

    from ..utils.buckets import snap_resolution

    color_map = None
    if req.get("color_map_png_b64"):
        color_map = _decode_image(req["color_map_png_b64"])
        h, w = color_map.shape[:2]
        bw, bh = snap_resolution(w, h)
        if (bh, bw) != (h, w):
            color_map = _resize(color_map, bw, bh, Image.NEAREST)
    init_image = mask_image = None
    if req.get("init_image_png_b64"):
        init_image = _decode_image(req["init_image_png_b64"])
        ih, iw = init_image.shape[:2]
        if ih % 64 or iw % 64:  # sizes on the lattice pass unresized
            bw, bh = snap_resolution(iw, ih)
            init_image = _resize(init_image, bw, bh, Image.BILINEAR)
    if req.get("mask_image_png_b64"):
        raw = base64.b64decode(req["mask_image_png_b64"])
        mask = np.asarray(Image.open(io.BytesIO(raw)).convert("L"))
        if init_image is not None and mask.shape[:2] != init_image.shape[:2]:
            mask = _resize(mask, init_image.shape[1], init_image.shape[0], Image.NEAREST)
        mask_image = mask.astype(np.float32) / 255.0
    wf = None
    if req.get("weight_function"):
        from ..ops.weight_functions import WeightFunction

        wf = WeightFunction(**req["weight_function"])
    freeu = req.get("freeu")
    extra = {}
    if req.get("ip_adapter_image_png_b64"):
        extra["ip_adapter_image"] = _decode_image(req["ip_adapter_image_png_b64"])
    return {
        "prompt": req.get("prompt", ""),
        "negative_prompt": req.get("negative_prompt", ""),
        "color_context": _parse_context(req.get("color_context", {})),
        "color_map_image": color_map,
        "seed": int(req.get("seed", 0)),
        "num_inference_steps": int(req.get("steps", 30)),
        "guidance_scale": float(req.get("guidance_scale", 7.5)),
        "weight_function": wf,
        "cache_interval": int(req.get("cache_interval", 1)),
        "tome_ratio": float(req.get("tome_ratio", 0.0)),
        "prompt_weighting": bool(req.get("prompt_weighting", False)),
        "clip_skip": int(req.get("clip_skip", 0)),
        "long_prompts": bool(req.get("long_prompts", False)),
        "prompt_editing": bool(req.get("prompt_editing", False)),
        "sag_scale": float(req.get("sag_scale", 0.0)),
        "freeu": True if freeu is True else tuple(freeu) if freeu else None,
        "init_image": init_image,
        "mask_image": mask_image,
        "strength": float(req.get("strength", 0.5)),
        "mask_blur": float(req.get("mask_blur", 0.0)),
        "masked_content": str(req.get("masked_content", "original")),
        **extra,
    }


def make_handler(batcher: Batcher, timeout_s: float = 600.0):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "stats": dict(batcher.stats)})
            elif self.path == "/metrics":
                self._send(200, batcher.metrics())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = request_from_json(json.loads(self.rfile.read(length)))
                t0 = time.time()
                img = batcher.submit(request).result(timeout=timeout_s)
                latency = time.time() - t0
                batcher.observe_latency(latency)
                self._send(200, {"image_png_b64": _encode_image(img),
                                 "latency_s": round(latency, 3)})
            except Exception as e:  # noqa: BLE001 - the client gets the error
                self._send(500, {"error": repr(e)})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def build_pipeline(model=None, tiny=False, device="cuda"):
    """The served pipeline: a diffusers directory (``from_pretrained``),
    the tiny random config, or SD-1.5 with synthetic weights; on the card
    in bf16, or on the CPU in f32."""
    import torch

    from ..config import SDModelConfig
    from ..pipeline.pipeline import PwwPipeline

    kw = dict(device=device,
              dtype=torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16)
    if model:
        return PwwPipeline.from_pretrained(model, **kw)
    return PwwPipeline(config=SDModelConfig.tiny() if tiny else None, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description="paint-with-words HTTP server (PyTorch port)")
    ap.add_argument("--model", default=None, help="a diffusers directory")
    ap.add_argument("--tiny", action="store_true", help="the tiny random config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--max-batch-pixels", type=int, default=None,
                    help="cap a group's output pixels (rows·h·w), so that large "
                         "sizes form smaller groups; default: no cap")
    args = ap.parse_args(argv)
    pipe = build_pipeline(args.model, args.tiny, args.device)
    batcher = Batcher(pipe, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                      max_batch_pixels=args.max_batch_pixels)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(batcher))
    print(f"serving on {args.host}:{server.server_address[1]} ({pipe.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
