"""The one traffic generator: a mix file of parameters in, requests and timed
completions out.

A mix (``portbench/traffic/<name>.json``) names the program's entry it
drives and the parameters of its requests; everything else is drawn from
the run's seed. Keys:

* ``entry``: ``"batcher"`` (``Batcher.submit`` on one pipeline, which runs
  ``generate_batch``) or ``"generate"``;
* ``loop``: ``{"kind": "closed", "clients": n}``: n clients, each sending
  its next request when the last one resolved (one client where the entry
  is a pipeline's own call);
* ``sizes``: [[height, width], ...], each request draws one;
* ``steps``, ``guidance_scale``; ``regions`` and ``prompt_words``: [least,
  most]; ``strength``: [least, most] of a region's strength;
* ``vocabulary``: the word file under ``portbench/``;
* ``batcher``: the Batcher's arguments.

Request k of client c is drawn from ``(seed, c, k)`` alone, so that a seed
gives the same requests whatever the timing, and every seed the same sizes
and steps. A request: a prompt of ``prompt_words`` words holding one label
for each region; a color map of the size, background black, with one
rectangle per region in its own column of the image (so that no region
hides another), in a color of its own; the context "label,strength"; and
a seed of its own for the program's noise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ENTRIES = ("batcher", "generate")


def load_mix(name: str, root: str = HERE) -> Dict:
    with open(os.path.join(root, "traffic", name + ".json")) as f:
        mix = json.load(f)
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"traffic {name}: entry must be one of {ENTRIES}")
    loop = mix["loop"]
    if loop["kind"] != "closed":
        raise ValueError(f"traffic {name}: the loop must be closed")
    if mix["entry"] != "batcher" and loop["clients"] != 1:
        raise ValueError(f"traffic {name}: one client calls a pipeline directly")
    with open(os.path.join(root, mix["vocabulary"])) as f:
        mix["_vocab"] = json.load(f)
    return mix


def make_request(mix: Dict, seed: int, client: int, k: int) -> Dict:
    """Request ``k`` of ``client`` under ``seed``: ``generate_batch``'s
    schema plus the steps and guidance."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, client, k])
    vocab = mix["_vocab"]
    h, w = mix["sizes"][int(rng.integers(len(mix["sizes"])))]
    n_reg = int(rng.integers(mix["regions"][0], mix["regions"][1] + 1))
    labels = [str(x) for x in rng.choice(vocab["labels"], n_reg, replace=False)]
    n_words = int(rng.integers(mix["prompt_words"][0], mix["prompt_words"][1] + 1))
    words = [str(x) for x in rng.choice(vocab["words"], max(n_words - n_reg, 0))] + labels
    prompt = " ".join(words[i] for i in rng.permutation(len(words)))
    cmap = np.zeros((h, w, 3), np.uint8)
    context = {}
    edges = np.sort(rng.choice(np.arange(1, 16), n_reg - 1, replace=False)) * (w // 16)
    cols = np.concatenate([[0], edges, [w]])
    for r, label in enumerate(labels):
        color = (int(rng.integers(1, 256)), int(rng.integers(0, 256)), 32 * r + 16)
        x0, x1 = int(cols[r]), int(cols[r + 1])
        y0 = int(rng.integers(0, h // 2)) // 8 * 8
        y1 = min(h, y0 + int(rng.integers(h // 4, h)) // 8 * 8)
        cmap[y0:y1, x0:x1] = color
        lo, hi = mix["strength"]
        context[color] = f"{label},{round(float(rng.uniform(lo, hi)), 2)}"
    return {"prompt": prompt, "color_map_image": cmap, "color_context": context,
            "seed": int(rng.integers(0, 2 ** 31)),
            "num_inference_steps": int(mix["steps"]),
            "guidance_scale": float(mix["guidance_scale"])}


@dataclasses.dataclass
class Record:
    """One request: when it was sent and when it resolved, seconds
    from the window's start; its image (H, W, 3) uint8 or its error."""

    client: int
    k: int
    request: Dict
    sent: float
    done: Optional[float] = None
    image: Optional[np.ndarray] = None
    error: Optional[str] = None


def call_for(mix: Dict, pipe, batcher=None) -> Callable[[Dict], object]:
    """The timed call of one request; it returns when the image is on the
    host. The batcher's returns a future."""
    if mix["entry"] == "batcher":
        return batcher.submit
    return lambda req: pipe.generate(**req, output_type="np")[0]


def _resolve(rec: Record, out, t0: float) -> None:
    try:
        img = out.result(timeout=600) if hasattr(out, "result") else out
        rec.image = np.asarray(img)
    except Exception as e:  # a failed request counts as failed, not as a crash
        rec.error = f"{type(e).__name__}: {e}"
    rec.done = time.perf_counter() - t0


def run_window(mix: Dict, call, seed: int, seconds: float) -> Dict:
    """Drive ``call`` with the mix's closed loop for ``seconds``; requests in
    flight at the close are waited for. Returns {"records", "seconds"}."""
    records: List[Record] = []
    lock = threading.Lock()
    t0 = time.perf_counter()

    def client(c: int):
        k = 0
        while time.perf_counter() - t0 < seconds:
            rec = Record(c, k, make_request(mix, seed, c, k), time.perf_counter() - t0)
            with lock:
                records.append(rec)
            try:
                out = call(rec.request)
            except Exception as e:
                rec.error, rec.done = f"{type(e).__name__}: {e}", time.perf_counter() - t0
            else:
                _resolve(rec, out, t0)
            k += 1

    if mix["loop"]["clients"] == 1:
        client(0)
    else:
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(mix["loop"]["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return {"records": records, "seconds": float(seconds)}
