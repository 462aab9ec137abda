"""Concrete environment state. Port of ``nnx_ppo_tpu/envs/types.py``.

Environments of the port are batched natively: every leaf has a leading
env axis ``[B]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class State:
    """Batched environment state: ``data`` holds the simulation state;
    ``done`` is bool or float depending on the env."""

    data: Any
    obs: Any
    reward: Any
    done: torch.Tensor
    info: dict[str, Any]
    metrics: dict[str, Any]

    def replace(self, **changes: Any) -> "State":
        return dataclasses.replace(self, **changes)
