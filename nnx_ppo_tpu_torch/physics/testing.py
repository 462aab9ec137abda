"""Inputs for checking the control steps: legged states near the standing
pose (the humanoid's with its feet pressed together in some envs), and arm
(and ball) states of the manipulation scenes.

No JAX counterpart (the JAX tests build such states inline). Everything
is numpy from a seed, so a check can hand the same arrays to the kernel,
to the plain version and to the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from nnx_ppo_tpu_torch.physics import model as port_model
from nnx_ppo_tpu_torch.physics.model import Model
from nnx_ppo_tpu_torch.physics.terrain import Terrain


def terrain_height_np(terrain: Optional[Terrain], xy: np.ndarray) -> np.ndarray:
    """``Terrain.height`` in float64 numpy (0 for ``None``)."""
    if terrain is None:
        return np.zeros(xy.shape[:-1])
    x, y = xy[..., 0], xy[..., 1]
    h = terrain.slope[0] * x + terrain.slope[1] * y
    for a, f, d, p in zip(terrain.amplitudes, terrain.frequencies, terrain.directions,
                          terrain.phases):
        h = h + a * np.sin(f * (d[0] * x + d[1] * y) + p)
    return h


def standing_states(
    model: Model,
    default_qpos: np.ndarray,
    batch_size: int,
    seed: int,
    *,
    terrain: Optional[Terrain] = None,
    n_extra_dr: int = 0,
    has_push: bool = False,
    spawn_radius: float = 5.0,
) -> dict[str, np.ndarray]:
    """``qpos``, ``qvel``, ``target`` (and ``extra`` when asked for) for
    ``batch_size`` envs around ``default_qpos``: random world xy, height
    within about 2 cm of the nominal stance above the local ground (so
    some feet touch and some do not), a tilt of a few degrees, joint
    noise 0.15 rad, velocities 0.3, PD targets 0.2 rad off the pose.
    ``extra`` holds ``n_extra_dr`` scales in [0.8, 1.2] and, with
    ``has_push``, a 50 N horizontal push on one env in five."""
    rng = np.random.RandomState(seed)
    B = batch_size
    qpos = np.tile(np.asarray(default_qpos, np.float64), (B, 1))
    qpos[:, :2] = spawn_radius * rng.uniform(-1.0, 1.0, (B, 2))
    qpos[:, 2] += terrain_height_np(terrain, qpos[:, :2]) + rng.uniform(-0.02, 0.01, B)
    quat = np.concatenate([np.ones((B, 1)), 0.04 * rng.randn(B, 3)], axis=1)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += 0.15 * rng.randn(B, model.nj)
    out = {
        "qpos": qpos.astype(np.float32),
        "qvel": (0.3 * rng.randn(B, model.nv)).astype(np.float32),
        "target": (qpos[:, 7:] + 0.2 * rng.randn(B, model.nj)).astype(np.float32),
    }
    parts = []
    if n_extra_dr:
        parts.append(rng.uniform(0.8, 1.2, (B, n_extra_dr)))
    if has_push:
        theta = rng.uniform(0.0, 2.0 * np.pi, B)
        on = (rng.rand(B) < 0.2) * 50.0
        parts.append(np.stack([on * np.cos(theta), on * np.sin(theta), np.zeros(B)], axis=1))
    if parts:
        out["extra"] = np.concatenate(parts, axis=1).astype(np.float32)
    return out


def humanoid_states(model: Model, batch_size: int, seed: int) -> dict[str, np.ndarray]:
    """:func:`standing_states` of the humanoid (``models/humanoid.py``)
    around its default pose, with, in every other env, both legs in the
    same pitch pose and both hip rolls turned inward by 0.1 rad (the PD
    targets by 0.15), so that the heel and toe spheres of the two feet
    press together (the self-collision pairs), and in every fourth env
    from the second a knee 0.15 rad past its lower stop (-0.05 rad)."""
    from nnx_ppo_tpu_torch.physics.models.humanoid import default_qpos

    out = standing_states(model, default_qpos(model), batch_size, seed)
    qpos, target = out["qpos"], out["target"]
    qpos[::2, 12:15] = qpos[::2, 8:11]  # right leg's pitch joints = the left's
    target[::2, 5:8] = target[::2, 1:4]
    qpos[::2, 7], qpos[::2, 11] = -0.1, 0.1  # hip rolls, toward each other
    target[::2, 0], target[::2, 4] = -0.15, 0.15
    qpos[1::4, 9] = -0.2  # the left knee past its stop
    return out


def _rotation(quat: np.ndarray) -> np.ndarray:
    """``[B, 3, 3]`` rotation matrices of unit quaternions ``(w, x, y, z)``."""
    w, x, y, z = quat.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(-1, 3, 3)


def manipulation_states(
    batch_size: int,
    seed: int,
    *,
    with_ball: bool,
    shoulder_height: float = 1.0,
    upper_len: float = 0.35,
    fore_len: float = 0.30,
    ball_radius: float = 0.08,
    torque: float = 6.0,
) -> dict[str, np.ndarray]:
    """``qpos``, ``qvel``, ``tau`` of ``batch_size`` envs of the arm
    (``models/arm.py``: ball shoulder, hinge elbow about y), concatenated
    with a free ball's when ``with_ball``: shoulder tilted by a rotation
    vector of std 0.6 rad, elbow angle of std 0.8 rad, velocities of std
    0.5, torques uniform in +-``torque`` (none on the ball). One ball in
    four sits 0.09 m from the end effector (inside the 0.11 m shell of the
    cross pair); the others lie on the ground 0.15 to 0.3 m from the base,
    pressed up to 1 cm into it or hovering up to 2 cm above."""
    rng = np.random.RandomState(seed)
    B = batch_size
    tilt = 0.6 * rng.randn(B, 3)
    angle = np.linalg.norm(tilt, axis=1, keepdims=True)
    quat = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * tilt / angle], axis=1)
    elbow = 0.8 * rng.randn(B, 1)
    qpos = [quat, elbow]
    qvel = [0.5 * rng.randn(B, 4)]
    tau = [torque * rng.uniform(-1.0, 1.0, (B, 4))]
    if with_ball:
        c, s = np.cos(elbow[:, 0]), np.sin(elbow[:, 0])
        forearm = np.stack([-s * fore_len, np.zeros(B), -c * fore_len], axis=1)  # Ry(elbow) [0, 0, -l]
        upper = np.array([0.0, 0.0, -upper_len])
        tip = np.array([0.0, 0.0, shoulder_height]) + np.einsum(
            "bij,bj->bi", _rotation(quat), upper + forearm
        )
        direction = rng.randn(B, 3)
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        theta = rng.uniform(0.0, 2.0 * np.pi, B)
        radius = rng.uniform(0.15, 0.3, B)
        on_ground = np.stack(
            [radius * np.cos(theta), radius * np.sin(theta),
             ball_radius + rng.uniform(-0.01, 0.02, B)], axis=1,
        )
        near_tip = (np.arange(B) % 4 == 0)[:, None]
        ball_pos = np.where(near_tip, tip + 0.09 * direction, on_ground)
        ball_quat = rng.randn(B, 4)
        ball_quat /= np.linalg.norm(ball_quat, axis=1, keepdims=True)
        qpos += [ball_pos, ball_quat]
        qvel.append(0.5 * rng.randn(B, 6))
        tau.append(np.zeros((B, 6)))
    return {
        "qpos": np.concatenate(qpos, axis=1).astype(np.float32),
        "qvel": np.concatenate(qvel, axis=1).astype(np.float32),
        "tau": np.concatenate(tau, axis=1).astype(np.float32),
    }


def general_tree(mod=port_model, cap: bool = True):
    """A tree with every joint type the general SoA dynamics take: FREE
    root, a HINGE about a skew axis with a stop and a spring, two SLIDE
    joints in a chain (the first with stops), a BALL leaf, three ground
    geoms and one pair inside the tree; ``nq = 15``, ``nv = 12``. ``mod``
    is the module whose ``ModelBuilder`` builds it (this package's
    ``physics.model``, or another package's with the same interface);
    ``cap=False`` leaves the contact force uncapped."""
    b = mod.ModelBuilder(gravity=-9.81)
    b.add_body("base", joint=mod.FREE, mass=2.0, com=(0.01, 0.0, 0.02), inertia=(0.02, 0.03, 0.025))
    b.add_body("l1", parent="base", joint=mod.HINGE, axis=(0.6, 0.0, 0.8), pos=(0.1, 0.0, -0.05),
               mass=0.7, com=(0.0, 0.01, -0.1), inertia=(0.004, 0.004, 0.001), damping=0.3,
               armature=0.01, limit=(-0.5, 0.7))
    b.add_body("l2", parent="l1", joint=mod.SLIDE, axis=(0.0, 0.0, 1.0), pos=(0.0, 0.0, -0.2),
               mass=0.4, com=(0.0, 0.0, -0.05), inertia=(0.001, 0.001, 0.0005), armature=0.02,
               limit=(-0.1, 0.1))
    b.add_body("l3", parent="l2", joint=mod.SLIDE, axis=(1.0, 0.0, 0.0), pos=(0.0, 0.0, -0.1),
               mass=0.3, com=(0.0, 0.0, -0.02), inertia=(0.001, 0.001, 0.0005), damping=0.1)
    b.add_body("l4", parent="base", joint=mod.BALL, pos=(-0.1, 0.0, 0.0), mass=0.5,
               com=(0.0, 0.0, -0.1), inertia=(0.002, 0.002, 0.001), damping=0.2, armature=0.01)
    b.add_sphere_geom("base", (0.0, 0.0, 0.0), 0.1)
    g1 = b.add_sphere_geom("l3", (0.0, 0.0, -0.05), 0.04)
    g2 = b.add_sphere_geom("l4", (0.0, 0.0, -0.2), 0.05)
    b.add_collision_pair(g1, g2)
    kw = dict(contact_stiffness=2000.0, contact_damping=20.0, friction=0.8, friction_vel=0.5)
    if cap:
        kw["max_contact_force"] = 60.0
    m = b.finalize(**kw)
    stiffness, ref = np.zeros(m.nv), np.zeros(m.nv)
    stiffness[6], ref[6] = 3.0, 0.1
    return dataclasses.replace(m, spring_stiffness=stiffness, spring_ref=ref)


def slider_tree(mod=port_model):
    """A tree rooted in the world by a SLIDE joint: a cart with a pole on a
    HINGE, one ground geom on each; ``nq = nv = 2``."""
    b = mod.ModelBuilder(gravity=-9.81)
    b.add_body("cart", joint=mod.SLIDE, axis=(1.0, 0.0, 0.0), pos=(0.0, 0.0, 0.3), mass=1.0,
               inertia=(0.01, 0.01, 0.01), damping=0.05)
    b.add_body("pole", parent="cart", joint=mod.HINGE, axis=(0.0, 1.0, 0.0), mass=0.2,
               com=(0.0, 0.0, 0.25), inertia=(0.004, 0.004, 0.0001), armature=0.001)
    b.add_sphere_geom("pole", (0.0, 0.0, 0.5), 0.05)
    b.add_sphere_geom("cart", (0.0, 0.0, -0.25), 0.06)
    return b.finalize(contact_stiffness=1500.0, contact_damping=10.0)


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def general_tree_states(batch_size: int, seed: int) -> dict[str, np.ndarray]:
    """``qpos``, ``qvel``, ``tau`` of :func:`general_tree`: the base 0.1
    to 0.2 m above the ground at a random orientation (so its geoms touch
    in some envs), joint positions partly beyond their stops."""
    rng = np.random.RandomState(seed)
    B = batch_size
    qpos = np.concatenate([
        0.1 * rng.randn(B, 2), 0.1 + 0.1 * rng.rand(B, 1), _unit(rng.randn(B, 4)),
        0.8 * rng.randn(B, 1), 0.12 * rng.randn(B, 2), _unit(rng.randn(B, 4)),
    ], axis=1)
    return {
        "qpos": qpos.astype(np.float32),
        "qvel": (0.5 * rng.randn(B, 12)).astype(np.float32),
        "tau": rng.randn(B, 12).astype(np.float32),
    }


def slider_tree_states(batch_size: int, seed: int) -> dict[str, np.ndarray]:
    """``qpos``, ``qvel``, ``tau`` of :func:`slider_tree`: the pole at any
    angle, so its tip touches the ground in some envs."""
    rng = np.random.RandomState(seed)
    B = batch_size
    return {
        "qpos": np.concatenate([0.3 * rng.randn(B, 1), 2.0 * rng.randn(B, 1)], axis=1).astype(np.float32),
        "qvel": (0.5 * rng.randn(B, 2)).astype(np.float32),
        "tau": rng.randn(B, 2).astype(np.float32),
    }
