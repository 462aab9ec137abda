"""Environments (port of ``nnx_ppo_tpu/envs``: the flagship cart-pole,
the legged joystick envs and the manipulation envs)."""

from nnx_ppo_tpu_torch.envs.classic import CartpoleBalance
from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick, legged_from_mjcf
from nnx_ppo_tpu_torch.envs.pusher import ArmPush
from nnx_ppo_tpu_torch.envs.quadruped import QuadrupedJoystick
from nnx_ppo_tpu_torch.envs.reacher import ArmReacher
from nnx_ppo_tpu_torch.envs.types import State

__all__ = [
    "ArmPush",
    "ArmReacher",
    "CartpoleBalance",
    "LeggedJoystick",
    "QuadrupedJoystick",
    "State",
    "legged_from_mjcf",
]
