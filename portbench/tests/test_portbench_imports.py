"""Running the harness loads no module of JAX or of the JAX package, and
the reference loads nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import CELLS, ROOT

PROBE = """
import json, sys, torch
sys.argv = ["x"]
from portbench import run
from portbench.tests.conftest import tiny_cell
cell = tiny_cell("{cell}")
cell["traffic"] = dict(cell["traffic"], n_envs=8, rollout_length=2, n_epochs=1, n_minibatches=2)
run.run_cell(cell, 5, 0.1, False, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nnx_ppo_tpu"}


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    loaded = _modules(PROBE.format(cell=cell))
    assert "nnx_ppo_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys\n"
            "import portbench.reference.quadruped_rough, portbench.reference.mlp_wide_bf16\n"
            "import portbench.reference.cartpole_gru\n"
            "import portbench.reference.ppo, portbench.check\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = _modules(code)
    assert not loaded & (FORBIDDEN | {"nnx_ppo_tpu_torch"})


def test_the_command_refuses_without_a_card_or_a_checkout(tmp_path):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "mlp_wide_bf16.e8192",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    here = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    import torch

    if not torch.cuda.is_available():
        assert here.returncode != 0 and not here.stdout.strip()
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(ROOT / "portbench", alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=alone, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
