"""The Go1-class quadruped model of the reference physics (numpy only; a
frozen copy of ``nnx_ppo_tpu_torch/physics/models/quadruped.py``):
free trunk, 4 legs x 3 hinges, foot-sphere contacts."""

from __future__ import annotations

import numpy as np

from portbench.reference.physics.model import FREE, HINGE, Model, ModelBuilder

# Leg attachment points on the trunk (x fwd, y left, z up), Go1-like.
_HIP_X, _HIP_Y = 0.19, 0.05
_LEG_POSITIONS = {
    "FR": (_HIP_X, -_HIP_Y),
    "FL": (_HIP_X, _HIP_Y),
    "RR": (-_HIP_X, -_HIP_Y),
    "RL": (-_HIP_X, _HIP_Y),
}
HIP_OFFSET = 0.08  # lateral offset hip→thigh
THIGH_LEN = 0.213
SHANK_LEN = 0.213
FOOT_RADIUS = 0.022

# Default standing pose: legs tucked under the trunk.
DEFAULT_JOINT_POSE = np.array([0.0, 0.8, -1.6] * 4)
# Spawn at static contact equilibrium: foot penetration = weight/(4k),
# not deeper — a deeper spawn launches the robot off the penalty springs.
STAND_HEIGHT = 0.312


def _rod_inertia(mass: float, length: float, radius: float = 0.02):
    """Solid-rod inertia about its COM, axis along -z (leg segments
    hang downward)."""
    i_perp = mass * (3 * radius**2 + length**2) / 12.0
    i_axial = 0.5 * mass * radius**2
    return (i_perp, i_perp, i_axial)


def make_quadruped(
    gravity: float = -9.81,
    contact_stiffness: float = 6_000.0,
    contact_damping: float = 120.0,
    friction: float = 0.8,
    self_collision: bool = False,
    joint_limits: bool = False,
) -> Model:
    """Build the Go1-class model. ``self_collision=True`` adds
    foot-vs-foot sphere pairs (left-right and same-side front-rear) so
    crossed-leg gaits feel contact instead of interpenetrating — the
    static pair list keeps the per-step cost at 4 extra sphere checks.
    ``joint_limits=True`` enforces Go1-like joint ranges (abduction
    ±0.86, hip [-0.69, 3.9], knee [-2.82, -0.89] rad) with the engine's
    spring-damper range penalty (``engine_soa.substep_soa``)."""
    lim = (lambda lo, hi: (lo, hi)) if joint_limits else (lambda lo, hi: None)
    b = ModelBuilder(gravity=gravity)
    b.add_body(
        "trunk",
        joint=FREE,
        mass=5.2,
        inertia=(0.024, 0.064, 0.072),  # Go1 trunk ballpark
    )
    foot_geoms: dict[str, int] = {}
    for leg, (x, y) in _LEG_POSITIONS.items():
        side = 1.0 if y > 0 else -1.0
        # Abduction: roll about x at the hip attachment.
        b.add_body(
            f"{leg}_hip",
            parent="trunk",
            joint=HINGE,
            axis=(1.0, 0.0, 0.0),
            pos=(x, y, 0.0),
            mass=0.6,
            com=(0.0, side * HIP_OFFSET / 2, 0.0),
            inertia=(0.0007, 0.0007, 0.0007),
            damping=2.0,
            armature=0.01,
            limit=lim(-0.86, 0.86),
        )
        # Hip pitch: thigh swings about y; thigh extends downward.
        b.add_body(
            f"{leg}_thigh",
            parent=f"{leg}_hip",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),
            pos=(0.0, side * HIP_OFFSET, 0.0),
            mass=0.9,
            com=(0.0, 0.0, -THIGH_LEN / 2),
            inertia=_rod_inertia(0.9, THIGH_LEN),
            damping=2.0,
            armature=0.01,
            limit=lim(-0.69, 3.9),
        )
        # Knee pitch at the thigh end; shank extends downward.
        b.add_body(
            f"{leg}_shank",
            parent=f"{leg}_thigh",
            joint=HINGE,
            axis=(0.0, 1.0, 0.0),
            pos=(0.0, 0.0, -THIGH_LEN),
            mass=0.15,
            com=(0.0, 0.0, -SHANK_LEN / 2),
            inertia=_rod_inertia(0.15, SHANK_LEN, radius=0.012),
            damping=2.0,
            armature=0.01,
            limit=lim(-2.82, -0.89),
        )
        foot_geoms[leg] = b.add_sphere_geom(
            f"{leg}_shank", (0.0, 0.0, -SHANK_LEN), FOOT_RADIUS
        )
    # Trunk corner spheres: belly-scrape penalty + fall detection.
    for cx in (_HIP_X, -_HIP_X):
        for cy in (_HIP_Y, -_HIP_Y):
            b.add_sphere_geom("trunk", (cx, cy, -0.04), 0.04)
    if self_collision:
        for a, c in (("FR", "FL"), ("RR", "RL"), ("FR", "RR"), ("FL", "RL")):
            b.add_collision_pair(foot_geoms[a], foot_geoms[c])
    return b.finalize(
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        friction=friction,
    )


def default_qpos(model: Model) -> np.ndarray:
    """Nominal standing configuration."""
    return np.concatenate(
        [
            [0.0, 0.0, STAND_HEIGHT],  # trunk position
            [1.0, 0.0, 0.0, 0.0],  # identity quaternion
            DEFAULT_JOINT_POSE,
        ]
    ).astype(np.float32)
