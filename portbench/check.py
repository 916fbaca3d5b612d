"""How ``correct`` is decided: the program's images against the reference's.

After the window: a sample, drawn from the seed, of the requests the timed
path finished; the reference (``portbench/reference``, float32, TF32 off)
works each one out again from its inputs and the drawn weights, and each
image is compared with the reference's as

    image_rel_l2 = ‖a − b‖ / ‖b‖,  a, b = pixels / 127.5 − 1,

the largest over the sample. ``correct`` holds where that is within the
cell's limit (``portbench/cells/<cell>.json``) and no request failed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    x = a.astype(np.float64) / 127.5 - 1.0
    y = b.astype(np.float64) / 127.5 - 1.0
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def judge(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], failed: int,
          limit: float) -> Tuple[Dict, bool]:
    """(the numbers compared, each with its limit; ``correct``) for the
    sample's (image, reference image) pairs and the requests that failed."""
    worst = max((rel_l2(a, b) for a, b in pairs), default=0.0)
    numbers = {"image_rel_l2": {"value": worst, "limit": float(limit)},
               "failed": {"value": int(failed), "limit": 0}}
    return numbers, bool(pairs) and worst <= limit and failed == 0


def sample(records, k: int, seed: int) -> List:
    done = [r for r in records if r.image is not None]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0xC4EC])
    pick = rng.choice(len(done), min(k, len(done)), replace=False) if done else []
    return [done[i] for i in sorted(pick)]


def build_reference(cfg: Dict, params: Dict, device, tok, tok2):
    """The reference's float32 models, from the drawn weights."""
    import torch

    from .reference.models import build
    from .reference.pipeline import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = build(cfg, "meta")
    for part, m in models.items():
        m.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           for k, v in params[part].items()}, strict=True, assign=True)
    return Reference(cfg, models, tok, tok2)


def reference_images(ref, mix: Dict, requests: List[Dict], rows: int) -> List[np.ndarray]:
    """The reference's image of each request, ``rows`` requests a batch."""
    steps, g = int(mix["steps"]), float(mix["guidance_scale"])
    out: List[np.ndarray] = []
    for i in range(0, len(requests), rows):
        out += list(ref.txt2img(requests[i:i + rows], steps, g))
    return out
