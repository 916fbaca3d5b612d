"""The work of one image, counted on the reference: ``FlopCounterMode`` over
its models on the meta device (shapes only, nothing runs). Attention counts
as its two matrix products, whatever kernel the program takes for it;
norms, softmax and elementwise work are not counted, as an MFU does not.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch


def _models(config: Dict):
    from ..reference.models import build

    return build(config, device="meta")


@lru_cache(maxsize=None)
def _counts(config_json: str, lat_h: int, lat_w: int) -> Dict[str, float]:
    import json

    from torch.utils.flop_counter import FlopCounterMode

    config = json.loads(config_json)
    m = _models(config)
    u = config["unet"]
    meta = torch.device("meta")
    ctx_dim = u["cross_attention_dim"]
    x = torch.empty(2, u["in_channels"], lat_h, lat_w, device=meta)
    ctx = torch.empty(2, 77, ctx_dim, device=meta)
    weights = {}
    for ratio in (1, 2, 4, 8):
        q = (lat_h // ratio) * (lat_w // ratio)
        weights[q] = torch.empty(2, q, 77, device=meta)
    pww = {"weights": weights, "coef": torch.empty((), device=meta)}
    added = None
    if u.get("addition_embed_type") == "text_time":
        added = {"text_embeds": torch.empty(2, config["clip2"]["projection_dim"], device=meta),
                 "time_ids": torch.empty(2, 6, device=meta)}
    out = {}
    with FlopCounterMode(display=False) as fc:
        m["unet"](x, torch.empty((), device=meta), ctx, pww, added)
    out["unet_visit"] = float(fc.get_total_flops())
    with FlopCounterMode(display=False) as fc:
        m["vae"].decode(torch.empty(1, 4, lat_h, lat_w, device=meta))
    out["decode"] = float(fc.get_total_flops())
    ids = torch.zeros(2, 77, dtype=torch.long, device=meta)
    with FlopCounterMode(display=False) as fc:
        m["clip"](ids, "penultimate" if "clip2" in m else "final")
        if "clip2" in m:
            m["clip2"](ids, "pooled")
    out["encode"] = float(fc.get_total_flops())
    return out


def counts(config: Dict, lat_h: int, lat_w: int) -> Dict[str, float]:
    """{"unet_visit": a CFG pair's UNet visit, "decode": one image's VAE
    decode, "encode": the text towers on the [uncond, cond] pair}, FLOPs."""
    import json

    return _counts(json.dumps(config, sort_keys=True), lat_h, lat_w)
