"""Shared by the benchmark's tests: a cell of ``BENCHMARK.json`` at a size
the CPU holds (the configuration's widths, few envs and short rollouts)."""

from __future__ import annotations

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(n_envs=16, rollout_length=4, n_epochs=2, n_minibatches=2)


# The physics cell waits for a later benchmark change (PERF.md, open
# questions); its configuration, builder and reference stay and are held
# here, at a tiny size, to the per-update limits read at its own size
# (8192 envs) on an H100 (PERF.md, the readings at seed 45596931).
QUADRUPED = {"name": "quadruped_rough.e8192", "config": "quadruped_rough", "traffic": "e8192",
             "chips": 1}
QUADRUPED_LIMITS = {"env_gap": 0.0026, "loss_gap": 1.5e-05, "grad_gap": 3.1e-05,
                    "update_gap": 2.5e-04, "change_gap": 1.8e-05}
CELLS = ("quadruped_rough.e8192", "mlp_wide_bf16.e8192")


def tiny_cell(name: str) -> dict:
    from portbench import cells

    bench = cells.benchmark(ROOT)
    if name == QUADRUPED["name"]:
        cell = cells.assemble(bench, QUADRUPED, QUADRUPED_LIMITS)
    else:
        cell = cells.cell(bench, name)
    cell["traffic"] = dict(cell["traffic"], **TINY)
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
