"""Everything the benchmark finds by name: the cells, configurations,
traffic mixes, limits, per-layer metric readers and frozen kernel counts.

``BENCHMARK.json`` names a cell's configuration and traffic; each of
those is a file of its own under this folder, and so is each per-layer
metric's reader and each kernel's count, so that a later change adds a
cell, a configuration, a mix or a metric by adding files alone:

* ``configs/<config>.json``: the sizes as run (the ``file`` of
  ``BENCHMARK.json``), and optionally the ``check`` block of checked
  steps and followed updates (``check.plan``), with
  ``configs/<config>.py`` building the port's objects from them (and,
  for a network that carries state, ``carry_state``) and
  ``reference/<config>.py`` the plain reference;
* ``traffic/<traffic>.json``: envs, rollout length, epochs,
  minibatches and world size;
* ``limits/<cell>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: ``read(record) -> float | None``;
* ``counts/<name>.py``: operations and bytes of a kernel or a network.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry with its configuration, traffic and metrics: the
    end-to-end ones it reports and the per-layer ones read in it."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    return assemble(bench, cells[workload], load_json("limits", workload))


def assemble(bench: dict, entry: dict, limits: dict) -> dict:
    """A cell from its entry (name, configuration, traffic, chips) and
    the limits of its numbers."""
    name = entry["name"]

    def reported(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return {
        "name": name,
        "entry": entry,
        "config": load_json("configs", entry["config"]),
        "traffic": load_json("traffic", entry["traffic"]),
        "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
        "per_layer": [m for m in bench["per_layer"] if reported(m)],
    }


def load_json(folder: str, name: str) -> dict:
    return json.loads((HERE / folder / f"{name}.json").read_text())


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` as a module (``name`` may hold dots)."""
    key = f"portbench.{folder}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    if "." not in name:
        return importlib.import_module(key)
    spec = importlib.util.spec_from_file_location(key, HERE / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The per-layer metric's ``read(record)``."""
    return load_module("metrics", metric).read
