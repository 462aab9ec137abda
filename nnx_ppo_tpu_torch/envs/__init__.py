"""Environments (port of ``nnx_ppo_tpu/envs``: the flagship cart-pole and
the legged joystick envs)."""

from nnx_ppo_tpu_torch.envs.classic import CartpoleBalance
from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick, legged_from_mjcf
from nnx_ppo_tpu_torch.envs.quadruped import QuadrupedJoystick
from nnx_ppo_tpu_torch.envs.types import State

__all__ = ["CartpoleBalance", "LeggedJoystick", "QuadrupedJoystick", "State", "legged_from_mjcf"]
