"""Fixtures of the benchmark's own tests (run: ``python -m pytest portbench/tests``).

``tiny_root``: a copy of the checkout's benchmark files under a temporary
directory with two more cells at tiny sizes on the CPU, one per entry
(the batcher, ``generate`` on an SDXL-shaped config), added
as a later change would add them: new files and new entries only. The
port itself is imported from this checkout.

Tests that need the card carry the ``card`` marker and skip without one;
whether a card is there is decided inside the fixture, never at import.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_CELLS = (("tiny_serve", "tiny_sd", "tiny_serve_mix", "batcher"),
              ("tiny_xl", "tiny_xl", "tiny_b1_mix", "generate"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the H100")


def tiny_config(kind: str) -> dict:
    """The port's tiny configs as configuration files; the towers take the
    benchmark tokenizer's ids (vocabulary 49408, EOS 49407)."""
    from pww_tpu_torch.config import SDModelConfig

    c = dataclasses.asdict(SDModelConfig.tiny() if kind == "sd" else SDModelConfig.tiny_xl())
    d = {k: c[k] for k in ("clip", "clip2", "unet", "vae", "scheduler") if c.get(k)}
    d["clip"]["vocab_size"] = 49408
    if "clip2" in d:
        d["clip2"].update(vocab_size=49408, eos_token_id=49407)
    d.update(force_zeros_for_empty_prompt=True, dtype="float32")
    return d


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    man = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for kind in ("sd", "xl"):
        (pb / "configs" / f"tiny_{kind}.json").write_text(json.dumps(tiny_config(kind)))
        man["configs"].append({"name": f"tiny_{kind}", "source": "the port's tiny config",
                               "file": f"portbench/configs/tiny_{kind}.json", "reduced": [],
                               "why": "CPU tests"})
    for cell, config, traffic, entry in TINY_CELLS:
        mix = json.load(open(os.path.join(REPO, "portbench", "traffic", "closed16_b8_512.json")))
        settings = json.load(open(os.path.join(REPO, "portbench", "cells", "sd15_serve_b8.json")))
        mix.update(sizes=[[64, 64]], steps=3, entry=entry)
        if entry == "batcher":
            mix["loop"]["clients"] = 4
            mix["batcher"]["max_batch"] = 2
        else:  # one client calling the pipeline, one image checked
            mix["loop"]["clients"] = 1
            del mix["batcher"]
            settings["check"].update(sample=1, rows=1)
        (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        (pb / "cells" / f"{cell}.json").write_text(json.dumps(settings))
        man["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                 "chips": 1, "why": "CPU tests"})
        for m in man["end_to_end"] + man["per_layer"]:
            if "sd15_serve_b8" in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return str(root)


def run_tiny(root: str, cell: str, seed: int = 2 ** 31 + 77, seconds: float = 2.0) -> dict:
    import time

    import torch

    from portbench import harness

    return harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                       dtype=torch.float32, root=root)
