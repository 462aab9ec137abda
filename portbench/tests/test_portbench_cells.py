"""Every name in ``BENCHMARK.json`` finds its files, and a cell,
configuration, traffic mix, metric and count are added by new files
alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

from portbench import cells
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_its_files():
    for w in BENCH["workloads"]:
        cell = cells.cell(BENCH, w["name"])
        assert cell["traffic"]["n_envs"] % cell["traffic"]["n_minibatches"] == 0
        assert cell["end_to_end"] and cell["per_layer"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"train_sps", "setup_s"}
        assert set(cell["limits"]) >= {"env_gap", "loss_gap", "grad_gap", "update_gap",
                                       "change_gap"}
        cells.load_module("configs", w["config"])
        cells.load_module("reference", w["config"])


def test_every_metric_has_a_reader_and_every_config_its_file():
    for m in BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]


def test_names_and_limits_of_the_contract():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a configuration (its
    sizes beside an existing builder and reference), a cell, a limits
    file, a metric with its reader and a count, and finds each by name
    without a file of the copy changed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "e64.json").write_text(json.dumps(
        {"n_envs": 64, "rollout_length": 8, "n_epochs": 2, "n_minibatches": 2, "world_size": 1}))
    cfg = json.loads((pb / "configs" / "mlp_wide_bf16.json").read_text())
    cfg["name"] = "mlp_narrow"
    cfg["network"]["actor_hidden"] = [64, 64]
    (pb / "configs" / "mlp_narrow.json").write_text(json.dumps(cfg))
    for folder in ("configs", "reference"):
        (pb / folder / "mlp_narrow.py").write_text(
            f"from portbench.{folder}.mlp_wide_bf16 import *  # noqa: F401,F403\n")
    (pb / "limits" / "mlp_narrow.e64.json").write_text(json.dumps({"env_gap": 1.0}))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return float(record['steps'])\n")
    (pb / "counts" / "nothing.py").write_text("def per_launch(cfg, traffic):\n    return None\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "mlp_narrow.e64", "config": "mlp_narrow", "traffic": "e64", "chips": 1,
         "why": "test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "steps_seen", "unit": "steps", "better": "higher", "source": "host_clock",
         "layer": "training loop", "moves": "train_sps", "workloads": ["mlp_narrow.e64"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts and "tests" not in p.parts}
    probe = (
        "from pathlib import Path\n"
        "from portbench import cells\n"
        "cell = cells.cell(cells.benchmark(Path('.')), 'mlp_narrow.e64')\n"
        "assert cell['traffic']['n_envs'] == 64\n"
        "assert cell['config']['network']['actor_hidden'] == [64, 64]\n"
        "assert [m['name'] for m in cell['per_layer']][-1] == 'steps_seen'\n"
        "assert cells.reader('steps_seen')({'steps': 3}) == 3.0\n"
        "assert cells.load_module('counts', 'nothing').per_launch({}, {}) is None\n"
        "assert cells.load_module('reference', 'mlp_narrow').Net\n"
        "assert cells.load_module('configs', 'mlp_narrow').build\n"
        "assert cells.HERE == Path('portbench').resolve()\n"
        "print('found')\n")
    # The copy comes first on the path (the working directory); the port
    # from the repository.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "found" in out.stdout
    for p, data in before.items():
        assert (tmp_path / p.relative_to(ROOT)).read_bytes() == data
