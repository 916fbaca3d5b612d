"""Adding a metric, a configuration, a traffic mix or a cell needs only new
files and new entries: a temporary copy takes them without an edit."""
import json
import os

from portbench import manifest

from .conftest import run_tiny


def test_a_new_metric_file_is_found_and_reported(tiny_root):
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "metrics", "serving.requests_attempted.py"), "w") as f:
        f.write("def read(run):\n    return len(run.records)\n")
    man = manifest.load(tiny_root)
    man["per_layer"].append({"name": "serving.requests_attempted", "unit": "requests",
                             "better": "higher", "source": "program_counter",
                             "layer": "serving", "moves": "images_per_s",
                             "workloads": ["tiny_serve"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    assert manifest.problems(man, tiny_root) == []
    names = [m["name"] for m in manifest.metrics_of(man, "tiny_serve", "per_layer")]
    assert "serving.requests_attempted" in names
    read = manifest.reader("per_layer", "serving.requests_attempted", pb)

    class Run:
        records = [1, 2, 3]
    assert read(Run) == 3


def test_cells_added_as_files_run(tiny_root):
    """The tiny cells of the fixture (a configuration, a mix and a cell file
    each, and entries) run through every entry and come out correct."""
    for cell in ("tiny_serve", "tiny_xl"):
        out = run_tiny(tiny_root, cell)
        assert out["correct"], (cell, out["check"])
        assert out["failed"] == 0 and out["attempted"] > 0
        names = {m["name"] for m in manifest.metrics_of(manifest.load(tiny_root), cell,
                                                          "end_to_end")}
        assert set(out["metrics"]) == names
        assert list(out)[-1] == "check"
