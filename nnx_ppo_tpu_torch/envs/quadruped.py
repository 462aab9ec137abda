"""Joystick-commanded quadruped locomotion on the in-repo rigid-body
step. Port of ``nnx_ppo_tpu/envs/quadruped.py``.

Per control step (50 Hz) the env runs 10 physics substeps at 500 Hz:
the 18×18 mass matrix (CRBA) and its Cholesky factor, bias forces
(RNEA), 8 sphere-ground contacts and two triangular solves, all inside
one launch of the control-step kernel. See
:class:`nnx_ppo_tpu_torch.envs.legged.LeggedJoystick` for the obs /
action / reward contract.
"""

from __future__ import annotations

from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick
from nnx_ppo_tpu_torch.physics.models import make_quadruped
from nnx_ppo_tpu_torch.physics.models.quadruped import DEFAULT_JOINT_POSE, STAND_HEIGHT


class QuadrupedJoystick(LeggedJoystick):
    """Velocity-command tracking for the 12-actuator Go1-class model."""

    def __init__(self, self_collision: bool = False, joint_limits: bool = False, **overrides):
        defaults = dict(kp=60.0, action_scale=0.5, max_command=(1.0, 0.5, 1.5))
        defaults.update(overrides)
        super().__init__(
            make_quadruped(self_collision=self_collision, joint_limits=joint_limits),
            DEFAULT_JOINT_POSE,
            STAND_HEIGHT,
            **defaults,
        )
