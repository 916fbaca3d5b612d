"""The SDXL serving cell's pieces on the CPU: a tiny two-tower batcher cell,
added as files and entries only, comes out correct; the readers it reports
load and read what a run hands them; the real ``BENCHMARK.json`` has its form."""
import json
import os
from types import SimpleNamespace

import pytest

from portbench import manifest

from .conftest import REPO, run_tiny

# the per-layer metrics the SDXL cell reports: the serving cell's readers,
# which key their site tables and FLOPs by the run's configuration, and the
# two spans of its own
XL_READERS = ("serving.rows_per_batch", "pipeline.denoise_ms_per_step.serve",
              "models.vae_decode_ms.serve", "kernels.k3_roofline.serve",
              "kernels.pww_roofline.serve", "step.mfu.serve", "device.idle_share.serve",
              "models.text_encode_ms.xl", "pipeline.encode_ms.xl")


def add_tiny_xl_serve(root: str) -> str:
    """A cell on the fixture's tiny two-tower config, shaped as
    ``sdxl_serve_b4_1024`` (its mix and cell file, cut to 64² and 3 steps,
    4 clients in groups of 2), reporting what that cell reports."""
    pb = os.path.join(root, "portbench")
    mix = json.load(open(os.path.join(REPO, "portbench", "traffic", "closed8_b4_1024.json")))
    mix.update(sizes=[[64, 64]], steps=3)
    mix["loop"]["clients"] = 4
    mix["batcher"]["max_batch"] = 2
    with open(os.path.join(pb, "traffic", "tiny_xl_serve_mix.json"), "w") as f:
        json.dump(mix, f)
    settings = json.load(open(os.path.join(REPO, "portbench", "cells",
                                           "sdxl_serve_b4_1024.json")))
    with open(os.path.join(pb, "cells", "tiny_xl_serve.json"), "w") as f:
        json.dump(settings, f)
    man = manifest.load(root)
    man["workloads"].append({"name": "tiny_xl_serve", "config": "tiny_xl",
                             "traffic": "tiny_xl_serve_mix", "chips": 1, "why": "CPU tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "sdxl_serve_b4_1024" in m.get("workloads", []):
            m["workloads"].append("tiny_xl_serve")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f, indent=1)
    return "tiny_xl_serve"


def test_the_real_manifest_has_the_xl_cell_and_no_problems():
    man = manifest.load(REPO)
    assert manifest.problems(man, REPO) == []
    w = manifest.workload(man, "sdxl_serve_b4_1024")
    assert (w["config"], w["traffic"], w["chips"]) == ("sdxl_base", "closed8_b4_1024", 1)
    e2e = {m["name"] for m in manifest.metrics_of(man, w["name"], "end_to_end")}
    assert e2e == {"images_per_s", "latency_p90_s", "setup_s"}
    layer = [m["name"] for m in manifest.metrics_of(man, w["name"], "per_layer")]
    assert layer == list(XL_READERS)


def test_a_two_tower_batcher_cell_added_as_files_runs_correct(tiny_root):
    cell = add_tiny_xl_serve(tiny_root)
    out = run_tiny(tiny_root, cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in manifest.metrics_of(manifest.load(tiny_root), cell,
                                                      "end_to_end")}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "check"


def _run(timers, stats=None):
    return SimpleNamespace(timers=timers, units=[(128, 128, 8, 30), (128, 128, 8, 30)],
                           batcher_stats=stats, trace=None, trace_units=None, launches={},
                           config_name="sdxl_base")


@pytest.mark.parametrize("name", XL_READERS)
def test_the_xl_cells_readers_load_and_read(name):
    read = manifest.reader("per_layer", name, os.path.join(REPO, "portbench"))
    timers = {"text": [0.02, 0.04], "encode": [0.1, 0.3], "denoise": [6.0, 6.6],
              "decode": [0.5, 0.7]}
    want = {"serving.rows_per_batch": 3.5, "models.text_encode_ms.xl": 30.0,
            "pipeline.encode_ms.xl": 200.0, "pipeline.denoise_ms_per_step.serve": 210.0,
            "models.vae_decode_ms.serve": 600.0}
    got = read(_run(timers, {"batches": 2, "batched_requests": 7}))
    if name in want:
        assert got == pytest.approx(want[name])
    else:  # device readers: nothing to read without a trace
        assert got is None


def test_a_program_without_the_text_phase_gives_nothing_to_read():
    """The parent's pipeline records no "text" phase: its reader is silent
    and the others read as before."""
    timers = {"encode": [0.1], "denoise": [6.0], "decode": [0.5]}
    pb = os.path.join(REPO, "portbench")
    assert manifest.reader("per_layer", "models.text_encode_ms.xl", pb)(_run(timers)) is None
    assert manifest.reader("per_layer", "pipeline.encode_ms.xl", pb)(_run(timers)) == \
        pytest.approx(100.0)
    assert manifest.reader("per_layer", "serving.rows_per_batch", pb)(_run(timers)) is None
