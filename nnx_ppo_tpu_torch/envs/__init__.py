"""Environments (port of ``nnx_ppo_tpu/envs``: the analytic control and
locomotion envs, the legged joystick envs on the rigid-body step (and
from MJCF), the manipulation envs and the MuJoCo adapter on the MuJoCo C
engine; MJX, an XLA program, has no counterpart)."""

from nnx_ppo_tpu_torch.envs.chain import NLinkSwingup
from nnx_ppo_tpu_torch.envs.classic import CartpoleBalance, CartpoleSwingup, Pendulum
from nnx_ppo_tpu_torch.envs.humanoid import HumanoidJoystick
from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick, legged_from_mjcf
from nnx_ppo_tpu_torch.envs.locomotion import JoystickLocomotion
from nnx_ppo_tpu_torch.envs.mjc_backend import MJC_AVAILABLE, MJCBackend, MJCData
from nnx_ppo_tpu_torch.envs.mjx import MJX_AVAILABLE, MJXCartpoleBalance, MJXEnv
from nnx_ppo_tpu_torch.envs.pusher import ArmPush
from nnx_ppo_tpu_torch.envs.quadruped import QuadrupedJoystick
from nnx_ppo_tpu_torch.envs.reacher import ArmReacher
from nnx_ppo_tpu_torch.envs.types import State

__all__ = [
    "ArmPush",
    "ArmReacher",
    "CartpoleBalance",
    "CartpoleSwingup",
    "HumanoidJoystick",
    "JoystickLocomotion",
    "LeggedJoystick",
    "MJCBackend",
    "MJCData",
    "MJC_AVAILABLE",
    "MJXCartpoleBalance",
    "MJXEnv",
    "MJX_AVAILABLE",
    "NLinkSwingup",
    "Pendulum",
    "QuadrupedJoystick",
    "State",
    "legged_from_mjcf",
]
