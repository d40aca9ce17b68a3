"""On the card: each cell of ``BENCHMARK.json`` run once through the
command, a short window, with ``correct`` true and the line well formed."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from test_portbench_drivers import well_formed
from toy import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    well_formed(line, cell, False)
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True, line["checks"]
