"""A configuration file (``portbench/configs/<name>.json``) for both sides.

The file holds the model's sizes under the program's field names. The
reference reads the dict as it is; the program gets its ``SDModelConfig``
built from the same fields, every field the file leaves out at the
program's own default (its kernel dispatch thresholds and norm-kernel
switches are the program's choice, not the model's).
"""
from __future__ import annotations

import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def load(path: str) -> Dict:
    with open(path if os.path.isabs(path) else os.path.join(os.path.dirname(HERE), path)) as f:
        return json.load(f)


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def program_config(cfg: Dict):
    """The program's ``SDModelConfig`` for a configuration dict."""
    from pww_tpu_torch.config import (CLIPTextConfig, SchedulerConfig, SDModelConfig,
                                      UNetConfig, VAEConfig)

    kw = dict(clip=CLIPTextConfig(**cfg["clip"]), unet=UNetConfig(**_tuples(cfg["unet"])),
              vae=VAEConfig(**_tuples(cfg["vae"])),
              scheduler=SchedulerConfig(**cfg["scheduler"]))
    if cfg.get("clip2"):
        kw["clip2"] = CLIPTextConfig(**cfg["clip2"])
    if "force_zeros_for_empty_prompt" in cfg:
        kw["force_zeros_for_empty_prompt"] = cfg["force_zeros_for_empty_prompt"]
    return SDModelConfig(**kw)
