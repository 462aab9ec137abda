"""Port of ``nnx_ppo_tpu/physics/models/humanoid.py`` (numpy only).

Planar-sagittal-dominant humanoid walker: free trunk + 2 legs ×
(hip roll, hip pitch, knee, ankle) + 2 shoulder-pitch arms = 10 hinge
joints = 16 dofs (6 free-base + 10 actuated), heel+toe foot contacts.

The HumanoidWalk-class workload on the in-repo engine: a bigger mass
matrix than the quadruped's per dof of the legs (4-deep leg chains, two
arms as leaves of the trunk) and heel and toe spheres on each foot.
Mass/geometry in a ~1.6 m, ~45 kg humanoid ballpark.
"""

from __future__ import annotations

import numpy as np

from nnx_ppo_tpu_torch.physics.model import FREE, HINGE, Model, ModelBuilder

THIGH_LEN = 0.40
SHANK_LEN = 0.40
FOOT_LEN = 0.18
FOOT_RADIUS = 0.03
HIP_Y = 0.10
ARM_LEN = 0.55

# knees slightly bent so the start pose is not a singular leg.
DEFAULT_JOINT_POSE = np.array(
    [
        0.0, -0.2, 0.4, -0.2,  # left leg: hip roll, hip pitch, knee, ankle
        0.0, -0.2, 0.4, -0.2,  # right leg
        0.0, 0.0,  # shoulders
    ]
)
# Hip height at the default pose: two 0.4 m segments at ±0.2 rad
# (2·0.4·cos(0.2) = 0.784) plus the foot-sphere stack (0.05), minus the
# static contact penetration (weight / (4 contacts · k) ≈ 0.009).
STAND_HEIGHT = 0.825


def make_humanoid(
    gravity: float = -9.81,
    contact_stiffness: float = 12_000.0,
    contact_damping: float = 250.0,
    friction: float = 0.9,
    self_collision: bool = False,
    joint_limits: bool = False,
) -> Model:
    """Build the biped model. ``self_collision=True`` adds the four
    left-vs-right foot sphere pairs (heel/toe cross product) so crossing
    steps collide instead of interpenetrating. ``joint_limits=True``
    enforces anthropomorphic joint ranges (hip roll ±0.5, hip pitch
    [-2.0, 1.0], knee [-0.05, 2.4], ankle ±0.9, shoulder ±1.6 rad) via
    the engine's spring-damper range penalty."""
    lim = (lambda lo, hi: (lo, hi)) if joint_limits else (lambda lo, hi: None)
    b = ModelBuilder(gravity=gravity)
    b.add_body(
        "trunk",
        joint=FREE,
        mass=22.0,
        com=(0.0, 0.0, 0.25),  # torso mass above the hips
        inertia=(0.9, 0.8, 0.25),
    )
    foot_geoms: dict[str, tuple[int, int]] = {}
    for side, sign in (("L", 1.0), ("R", -1.0)):
        b.add_body(
            f"{side}_hip",
            parent="trunk",
            joint=HINGE,
            axis=(1.0, 0.0, 0.0),  # roll
            pos=(0.0, sign * HIP_Y, 0.0),
            mass=1.0,
            inertia=(0.005, 0.005, 0.005),
            damping=4.0,
            armature=0.02,
            limit=lim(-0.5, 0.5),
        )
        b.add_body(
            f"{side}_thigh",
            parent=f"{side}_hip",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),  # pitch
            pos=(0.0, 0.0, 0.0),
            mass=5.5,
            com=(0.0, 0.0, -THIGH_LEN / 2),
            inertia=(0.08, 0.08, 0.01),
            damping=4.0,
            armature=0.02,
            limit=lim(-2.0, 1.0),
        )
        b.add_body(
            f"{side}_shank",
            parent=f"{side}_thigh",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),
            pos=(0.0, 0.0, -THIGH_LEN),
            mass=2.8,
            com=(0.0, 0.0, -SHANK_LEN / 2),
            inertia=(0.04, 0.04, 0.005),
            damping=4.0,
            armature=0.02,
            limit=lim(-0.05, 2.4),
        )
        b.add_body(
            f"{side}_foot",
            parent=f"{side}_shank",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),
            pos=(0.0, 0.0, -SHANK_LEN),
            mass=0.9,
            com=(FOOT_LEN / 4, 0.0, -FOOT_RADIUS),
            inertia=(0.002, 0.004, 0.004),
            damping=2.0,
            armature=0.01,
            limit=lim(-0.9, 0.9),
        )
        # Heel + toe spheres for pitch-stable stance (symmetric lever).
        foot_geoms[side] = (
            b.add_sphere_geom(f"{side}_foot", (-FOOT_LEN / 2, 0.0, -0.02),
                              FOOT_RADIUS),
            b.add_sphere_geom(f"{side}_foot", (FOOT_LEN / 2, 0.0, -0.02),
                              FOOT_RADIUS),
        )
    for side, sign in (("L", 1.0), ("R", -1.0)):
        b.add_body(
            f"{side}_arm",
            parent="trunk",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),
            pos=(0.0, sign * 0.22, 0.45),
            mass=2.0,
            com=(0.0, 0.0, -ARM_LEN / 2),
            inertia=(0.05, 0.05, 0.005),
            damping=2.0,
            armature=0.01,
            limit=lim(-1.6, 1.6),
        )
    # Trunk/head spheres: fall contact + termination proxy.
    b.add_sphere_geom("trunk", (0.0, 0.0, 0.55), 0.1)
    b.add_sphere_geom("trunk", (0.0, 0.0, 0.0), 0.09)
    if self_collision:
        for ga in foot_geoms["L"]:
            for gb in foot_geoms["R"]:
                b.add_collision_pair(ga, gb)
    return b.finalize(
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        friction=friction,
    )


def default_qpos(model: Model) -> np.ndarray:
    """Nominal standing configuration."""
    return np.concatenate(
        [
            [0.0, 0.0, STAND_HEIGHT],
            [1.0, 0.0, 0.0, 0.0],
            DEFAULT_JOINT_POSE,
        ]
    ).astype(np.float32)
