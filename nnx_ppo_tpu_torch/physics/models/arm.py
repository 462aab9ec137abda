"""Port of ``nnx_ppo_tpu/physics/models/arm.py`` (numpy only).

Pedestal-mounted 4-dof manipulator: ball shoulder + hinge elbow.

The manipulation-family model (reaching workload class) and the first
production user of the engine's ball joint: the shoulder is a genuine
3-dof spherical joint (quaternion state, child-frame ω), not a
roll-pitch-yaw hinge stack — no gimbal lock, one joint transform per
step. The arm hangs from a fixed pedestal at 1 m; both segments point
straight down at the zero configuration (the stable rest pose).
"""

from __future__ import annotations

import numpy as np

from nnx_ppo_tpu_torch.physics.model import BALL, HINGE, Model, ModelBuilder

UPPER_LEN = 0.35
FORE_LEN = 0.30
SHOULDER_HEIGHT = 1.0
# End-effector tip in the forearm frame.
EE_OFFSET = np.array([0.0, 0.0, -FORE_LEN])


def _rod_inertia(mass: float, length: float, radius: float = 0.03):
    i_perp = mass * (3 * radius**2 + length**2) / 12.0
    i_axial = 0.5 * mass * radius**2
    return (i_perp, i_perp, i_axial)


def make_arm(
    gravity: float = -9.81,
    shoulder_height: float = SHOULDER_HEIGHT,
    **contact_params,
) -> Model:
    b = ModelBuilder(gravity=gravity)
    # Ball shoulder needs nonzero rotational inertia about every axis
    # (see physics docs); the rod's axial term covers the long axis.
    b.add_body(
        "upper_arm",
        joint=BALL,
        pos=(0.0, 0.0, shoulder_height),
        mass=1.8,
        com=(0.0, 0.0, -UPPER_LEN / 2),
        inertia=_rod_inertia(1.8, UPPER_LEN),
        damping=0.8,
        armature=0.01,
    )
    b.add_body(
        "forearm",
        parent="upper_arm",
        joint=HINGE,
        axis=(0.0, 1.0, 0.0),
        pos=(0.0, 0.0, -UPPER_LEN),
        mass=1.1,
        com=(0.0, 0.0, -FORE_LEN / 2),
        inertia=_rod_inertia(1.1, FORE_LEN, radius=0.025),
        damping=0.8,
        armature=0.01,
        limit=(-2.6, 2.6),
    )
    b.add_sphere_geom("forearm", tuple(EE_OFFSET), 0.03)
    return b.finalize(**contact_params)


def default_qpos(model: Model) -> np.ndarray:
    """Hanging rest: identity shoulder quaternion, straight elbow."""
    return np.array([1.0, 0.0, 0.0, 0.0, 0.0], np.float32)
