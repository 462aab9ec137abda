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
# A policy that carries state, with no cell yet (PERF.md, open
# questions): held here, at a tiny size, to the limits read at the JAX
# suite's size (1024 envs, T 30, 4 x 4) on an H100 (PERF.md, the carry's readings).
CARTPOLE_GRU = {"name": "cartpole_gru.e1024", "config": "cartpole_gru", "traffic": "e1024",
                "chips": 1}
CARTPOLE_GRU_LIMITS = {"env_gap": 7.5e-06, "loss_gap": 5.9e-07, "grad_gap": 5.1e-06,
                       "update_gap": 3.5e-04, "change_gap": 1.2e-05, "carry_gap": 1.6e-05}
WITHOUT_CELL = {QUADRUPED["name"]: (QUADRUPED, QUADRUPED_LIMITS),
                CARTPOLE_GRU["name"]: (CARTPOLE_GRU, CARTPOLE_GRU_LIMITS)}
CELLS = ("quadruped_rough.e8192", "mlp_wide_bf16.e8192", "cartpole_gru.e1024")


def full_cell(name: str) -> dict:
    """The cell at its own size: a cell of ``BENCHMARK.json``, or one of
    :data:`WITHOUT_CELL` with its limits."""
    from portbench import cells

    bench = cells.benchmark(ROOT)
    if name in WITHOUT_CELL:
        return cells.assemble(bench, *WITHOUT_CELL[name])
    return cells.cell(bench, name)


def tiny_cell(name: str, **traffic) -> dict:
    cell = full_cell(name)
    cell["traffic"] = dict(cell["traffic"], **{**TINY, **traffic})
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
