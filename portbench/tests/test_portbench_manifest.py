"""BENCHMARK.json has the contract's form, and each name it gives has its file."""
import dataclasses
import json
import os

import pytest

from portbench import manifest, modelcfg

from .conftest import REPO


def test_manifest_has_no_problems():
    assert manifest.problems(manifest.load(REPO), REPO) == []


@pytest.mark.parametrize("bad, what", [
    (lambda m: m["end_to_end"][0].update(name="two words"), "name"),
    (lambda m: m["end_to_end"][0].update(unit="images per s"), "unit"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda m: m["per_layer"][0].update(why="x"), "keys"),
    (lambda m: m["configs"][0].update(reduced=["hidden_size"]), "reduced"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
    (lambda m: m["per_layer"][0].update(name="no.such.reader"), "reader"),
])
def test_manifest_problems_are_found(bad, what):
    m = manifest.load(REPO)
    bad(m)
    assert manifest.problems(m, REPO), what


def test_names_and_units_use_the_allowed_characters():
    m = manifest.load(REPO)
    for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert manifest.NAME.match(x["name"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert manifest.UNIT.match(x["unit"])
        assert x["unit"].isascii()


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest.load(REPO)
    for w in m["workloads"]:
        e2e = {x["name"] for x in manifest.metrics_of(m, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(m, w["name"], "per_layer")


@pytest.mark.parametrize("name, preset", [("sd15", "sd15"), ("sdxl_base", "sdxl")])
def test_config_file_is_the_published_config(name, preset):
    """The file's sizes give the program's own preset, field for field."""
    from pww_tpu_torch.config import SDModelConfig

    got = modelcfg.program_config(modelcfg.load(f"portbench/configs/{name}.json"))
    assert dataclasses.asdict(got) == dataclasses.asdict(getattr(SDModelConfig, preset)())


def test_layers_in_perf_md():
    """Every per-layer metric's layer is named in PERF.md's list of layers."""
    text = open(os.path.join(REPO, "PERF.md")).read()
    for x in manifest.load(REPO)["per_layer"]:
        assert f"| {x['layer']} |" in text, x["layer"]


def test_bounds_and_run_seconds_fit_the_check():
    m = manifest.load(REPO)
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert json.loads(json.dumps(m)) == m
