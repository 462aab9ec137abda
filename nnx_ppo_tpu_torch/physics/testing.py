"""Inputs for checking the control step: states near the standing pose.

No JAX counterpart (the JAX tests build such states inline). Everything
is numpy from a seed, so a check can hand the same arrays to the kernel,
to the plain version and to the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
