"""Joystick-commanded humanoid walking on the in-repo rigid-body step.
Port of ``nnx_ppo_tpu/envs/humanoid.py``.

The 16-dof biped (free base + 10 actuated hinges, heel and toe spheres on
each foot, two trunk spheres) with the PD gains, command ranges and
termination thresholds of the JAX env. Per control step one launch of
the control-step kernel (``csrc/control_step.cu``, built at the
humanoid's own sizes) runs the factor and all substeps. See
:class:`nnx_ppo_tpu_torch.envs.legged.LeggedJoystick` for the obs /
action / reward contract.

Standing is actively unstable (as for the real robot): with pure
joint-space PD the pitch mode diverges in ~1–2 s, so the policy must
learn balance; the termination thresholds suit a ~0.8 m hip height.
"""

from __future__ import annotations

from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick
from nnx_ppo_tpu_torch.physics.models import make_humanoid
from nnx_ppo_tpu_torch.physics.models.humanoid import DEFAULT_JOINT_POSE, STAND_HEIGHT


class HumanoidJoystick(LeggedJoystick):
    """Velocity-command walking for the 10-actuator biped. The first four
    ground geoms are the heel and toe spheres (``n_feet=4``)."""

    observation_size = {"proprio": 36, "command": 3}
    action_size: int = 10

    def __init__(self, self_collision: bool = False, joint_limits: bool = False, **overrides):
        defaults = dict(
            kp=350.0,
            action_scale=0.4,
            max_command=(1.0, 0.3, 1.0),
            min_up=0.6,
            min_height=0.45,
            reset_joint_noise=0.05,
        )
        defaults.update(overrides)
        super().__init__(
            make_humanoid(self_collision=self_collision, joint_limits=joint_limits),
            DEFAULT_JOINT_POSE,
            STAND_HEIGHT,
            **defaults,
        )
