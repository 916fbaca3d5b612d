"""On the card: one short run of each cell end to end, as the driver runs
it (``python -m pytest portbench/tests -m card`` on the H100)."""
import json
import os
import subprocess
import sys

import pytest

from portbench import manifest

from .conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load(REPO)["workloads"]])
def test_a_short_run_is_correct_and_well_formed(card, cell):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 19), "--seconds", "8", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=1200, env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "check"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
