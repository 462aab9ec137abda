"""Host-side numpy drawing shared by the envs' ``render`` (the JAX envs
each keep a copy of ``draw_line``: ``nnx_ppo_tpu/envs/legged.py:600``,
``reacher.py:145``, ``pusher.py:179``). No graphics dependency: frames
are HWC ``uint8`` arrays drawn pixel by pixel."""

from __future__ import annotations

import numpy as np
import torch

from nnx_ppo_tpu_torch.physics.engine import fwd_kinematics
from nnx_ppo_tpu_torch.physics.model import Model


def draw_line(frame: np.ndarray, a, b, color) -> None:
    """A 2-pixel-wide line from pixel ``a`` to pixel ``b`` (x, y), sampled
    at twice its length, clipped to the frame."""
    height, width = frame.shape[:2]
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
    for t in np.linspace(0.0, 1.0, 2 * n):
        px = int(a[0] + t * (b[0] - a[0]))
        py = int(a[1] + t * (b[1] - a[1]))
        if 0 <= px < width - 1 and 0 <= py < height - 1:
            frame[py : py + 2, px : px + 2, :] = color


def body_frames(model: Model, qpos_frames: list) -> tuple[np.ndarray, np.ndarray]:
    """World positions ``[N, n_bodies, 3]`` and rotations ``[N, n_bodies,
    3, 3]`` (float32) of every body at each of ``N`` frames' ``qpos``, by
    the port's ``fwd_kinematics`` over all frames in one call."""
    qpos = torch.from_numpy(np.stack([np.asarray(q, np.float32) for q in qpos_frames]))
    kin = fwd_kinematics(model, qpos)
    return torch.stack(kin.p, 1).numpy(), torch.stack(kin.E, 1).numpy()
