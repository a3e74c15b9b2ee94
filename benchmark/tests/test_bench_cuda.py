"""On the card: each cell, at its own size, runs as the checks run it and
is correct; its control is not.

    python -m pytest -q -m cuda benchmark/tests
"""

import json
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.harness import loader

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in loader.benchmark_json()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(cuda_device, workload):
    proc = subprocess.run(
        [sys.executable, str(loader.BENCH_DIR / "run.py"), "--workload",
         workload, "--seed", "2718281828", "--seconds", "2", "--trace", "0"],
        cwd=str(loader.ROOT), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], proc.stderr[-4000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] >= 1
    assert set(res["metrics"]) == set(loader.end_to_end(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(cuda_device, workload):
    r = control.reading(workload, 3141592653, cuda_device)
    assert r["exact"]["correct"] and not r["control"]["correct"], r
