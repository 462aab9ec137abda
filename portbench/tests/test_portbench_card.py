"""On the card: one short run of each cell through the command, in both
trace modes, correct and with every metric the cell names; the policy
that carries state at its own size, correct on three seeds and not with
its carry left unreset; a stand-in of the size of a 700M-parameter
model, checked on one step with the first and last updates followed,
within four host copies of its parameters and moments.

``python3 -m pytest portbench/tests -m gpu -s`` on the card prints what
the last two read (seeds, gaps, host copies, peak host memory, the
check's seconds)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import cells
from portbench.tests.conftest import ROOT, full_cell

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


def _exact_float32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_the_policy_that_carries_state_on_the_card(cuda_device, monkeypatch):
    from nnx_ppo_tpu_torch.networks import GRU

    from portbench import run

    _exact_float32()
    cell = full_cell("cartpole_gru.e1024")
    for seed in (2718281828, 1414213562, 1732050807):
        result = run.run_cell(cell, seed, 2.0, False, cuda_device)
        print("cartpole_gru.e1024", seed, json.dumps(result["checked"]))
        assert result["correct"] is True, result["checked"]
    monkeypatch.setattr(GRU, "reset_state", lambda self, prev_state: prev_state)
    result = run.run_cell(cell, 2236067977, 2.0, False, cuda_device)
    print("cartpole_gru.e1024 carry_not_reset", json.dumps(result["checked"]))
    assert result["correct"] is False, result["checked"]
    assert result["checked"]["carry_gap"]["value"] > result["checked"]["carry_gap"]["limit"]


# Actor 5 -> 8192 x 7 -> 2 and critic 5 -> 8192 x 6 -> 1 on the wide
# MLP's configuration: 738M parameters, the size of one 10-layer period
# of a 746M hybrid model.
WIDE = {"actor_hidden": [8192] * 7, "critic_hidden": [8192] * 6}
MIN_PARAMS = 700_000_000


@pytest.mark.gpu
def test_a_700m_parameter_stand_in_is_checked_within_four_host_copies(cuda_device, monkeypatch):
    import resource
    import time

    from portbench import check, program, run

    _exact_float32()
    cell = full_cell("mlp_wide_bf16.e8192")
    cell["config"] = dict(cell["config"], network=dict(cell["config"]["network"], **WIDE),
                          check={"steps": 1, "updates": []})
    cell["traffic"] = dict(cell["traffic"], n_envs=64, rollout_length=20)
    n_params = sum(int(torch_numel(shape)) for _, shape, _ in
                   cells.load_module("reference", "mlp_wide_bf16").parameters(cell["config"]))
    assert n_params >= MIN_PARAMS
    seen, check_s = [], []
    check_steps, compare = program.Program.check_steps, check.compare

    def kept(self, *args):
        seen.append(self)
        return check_steps(self, *args)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = compare(*args, **kwargs)
        check_s.append(time.perf_counter() - t0)
        return out

    monkeypatch.setattr(program.Program, "check_steps", kept)
    monkeypatch.setattr(check, "compare", timed)
    result = run.run_cell(cell, 3141592653, 2.0, False, cuda_device)
    copies = seen[0].state_copies
    print("stand-in", json.dumps({"params": n_params, "state_copies": copies,
                                  "host_copy_bytes": copies * 12 * n_params,
                                  "peak_rss_bytes": resource.getrusage(
                                      resource.RUSAGE_SELF).ru_maxrss * 1024,
                                  "check_s": check_s[0], "checked": result["checked"],
                                  "memory_peak_bytes": result["device"]["memory_peak_bytes"]}))
    assert result["correct"] is True, result["checked"]
    assert copies * 12 * n_params <= 4 * 12 * n_params


def torch_numel(shape) -> int:
    import torch

    return torch.Size(shape).numel()
