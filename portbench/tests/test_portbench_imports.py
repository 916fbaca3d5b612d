"""Nothing a run imports is JAX or the JAX package, by whole top-level names;
the reference imports nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

from .conftest import REPO

PB = os.path.join(REPO, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pww_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compare_whole():
    from portbench.harness import FORBIDDEN as H

    assert "pww_tpu_torch".split(".")[0] not in H
    assert set(H) == FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_in_benchmark_sources(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(imported_tops(path)) & (FORBIDDEN | {"pww_tpu_torch"})


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "out = harness.run('tiny_xl', 5, 1.0, False, time.perf_counter(), device='cpu',"
        " dtype=torch.float32, root=%r)\n"
        "print(harness.forbidden_modules(), out['correct'])\n" % (tiny_root, REPO, tiny_root))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_a_card_and_prints_nothing():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sd15_serve_b8",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""


def test_run_fails_where_the_checkout_holds_only_the_benchmark(tmp_path):
    import shutil

    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sd15_serve_b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
