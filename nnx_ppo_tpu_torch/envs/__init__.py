"""Environments (port of ``nnx_ppo_tpu/envs``, flagship subset)."""

from nnx_ppo_tpu_torch.envs.classic import CartpoleBalance
from nnx_ppo_tpu_torch.envs.types import State

__all__ = ["CartpoleBalance", "State"]
