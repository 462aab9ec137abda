"""On the card: one short run of each cell through the command, in both
trace modes, correct and with every metric the cell names."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import cells
from portbench.tests.conftest import ROOT

BENCH = cells.benchmark(ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(cuda_device, name, trace):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", name, "--seed", "3141592653",
           "--seconds", "3", "--trace", str(trace)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checked"]
    cell = cells.cell(BENCH, name)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    assert result["device"]["platform"] == "gpu"
