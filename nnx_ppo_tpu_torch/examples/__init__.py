"""The JAX package's example scripts (``examples/``), ported file for file.

Each script keeps its JAX counterpart's name, flags, defaults, console
lines and CSV columns, and runs as a module::

    python -m nnx_ppo_tpu_torch.examples.legged_training --env humanoid
    python -m nnx_ppo_tpu_torch.examples.arm_reaching --cpu --total-steps 100000

Each exposes ``build(args, device) -> (env, networks, train_config)`` and
``main(argv=None)``. Without ``--cpu`` a script runs on ``"cuda"`` and
raises where no GPU is present. Curves are written under ``results/``
beside this file unless ``--out`` says otherwise. The root package does
not import this one: it holds entry points, not library code.
"""

from __future__ import annotations

import csv
import os
from collections.abc import Iterable, Sequence

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def results_path(name: str) -> str:
    """Default output path of a curve: ``results/<name>`` beside this file."""
    return os.path.join(RESULTS_DIR, name)


def write_csv(path: str, fieldnames: Sequence[str], rows: Iterable[dict]) -> None:
    """Rows of dicts to ``path`` with a header, making its directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(fieldnames))
        writer.writeheader()
        writer.writerows(rows)
