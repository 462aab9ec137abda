"""3-D target reaching with a ball-shoulder manipulator, batched.

Port of ``nnx_ppo_tpu/envs/reacher.py`` (``ArmReacher`` :29). Torque
control (no PD: a quaternion joint has no scalar position error), dense
exp-distance reward, per-episode targets drawn from the reachable shell.
The JAX env steps one env and is vmapped; this one holds ``[B, ...]``
tensors and advances all envs at once. ``substep_impl`` takes JAX's
values (``reacher.py:50-80``): ``"auto"`` and ``"pallas"`` step through
the scene control-step runner (``physics/cuda_scene_step.py``, a scene of
one tree and no pairs: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors), ``"xla"`` through the generic engine's
``engine.step`` (eager PyTorch, JAX ``reacher.py:200-210``).

Randomness: ``reset`` takes the caller's device ``torch.Generator``; every
draw sits behind ``_draw_reset`` so that a test can inject another
package's draws through ``_reset_from``. ``step`` draws nothing.

``render`` rasterizes a trajectory on the host with numpy (JAX
``reacher.py:130``).
"""

from __future__ import annotations

import numpy as np
import torch

from nnx_ppo_tpu_torch.envs.raster import body_frames, draw_line
from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.physics.cuda_scene_step import make_scene_control_step_runner
from nnx_ppo_tpu_torch.physics.engine import fwd_kinematics, step
from nnx_ppo_tpu_torch.physics.models.arm import (
    EE_OFFSET,
    FORE_LEN,
    SHOULDER_HEIGHT,
    UPPER_LEN,
    default_qpos,
    make_arm,
)
from nnx_ppo_tpu_torch.physics.spatial import quat_integrate


def end_effector_position(model, arm_qpos: torch.Tensor) -> torch.Tensor:
    """World position ``[B, 3]`` of the arm's end-effector tip."""
    kin = fwd_kinematics(model, arm_qpos)
    offset = torch.tensor(EE_OFFSET, dtype=torch.float32, device=arm_qpos.device)
    return kin.p[1] + kin.E[1] @ offset


class ArmReacher:
    """Drive the end effector to a 3-D target and hold it there.

    Observation ``[B, 18]``: shoulder quaternion (4) ‖ shoulder ω (3) ‖
    elbow angle/rate (2) ‖ end-effector position (3) ‖ target (3) ‖
    target − end-effector (3), positions relative to the shoulder.
    Action ``[B, 4]``: torques (shoulder x/y/z in the child frame, elbow),
    scaled by ``torque_scale``. Reward: ``exp(-(d/σ)²) − ctrl penalty``.
    """

    observation_size: int = 18
    action_size: int = 4

    def __init__(
        self,
        torque_scale: float = 6.0,
        sigma: float = 0.15,
        ctrl_cost: float = 0.01,
        control_dt: float = 0.02,
        n_substeps: int = 4,
        target_radius: tuple[float, float] = (0.25, 0.6),
        substep_impl: str = "auto",
    ):
        self.model = make_arm()
        self.torque_scale = torque_scale
        self.sigma = sigma
        self.ctrl_cost = ctrl_cost
        self.control_dt = control_dt
        self.n_substeps = n_substeps
        self.physics_dt = control_dt / n_substeps
        self.target_radius = target_radius
        self.reach = UPPER_LEN + FORE_LEN
        if substep_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"substep_impl must be 'auto'|'xla'|'pallas', got {substep_impl!r}"
            )
        self.substep_impl = substep_impl
        # A control step of the ball+hinge arm in one kernel launch, or
        # (None) the generic engine's substeps.
        self._scene_runner = None
        if substep_impl != "xla":
            self._scene_runner = make_scene_control_step_runner(
                (self.model,), (), self.physics_dt, n_substeps
            )

    # -- draws ---------------------------------------------------------------

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """Everything ``reset`` draws: ``tilt[B, 3]``, ``qvel_noise[B, 4]``
        and ``target_dir[B, 3]`` (unit normal) and ``target_radius[B]``
        (uniform over ``self.target_radius``)."""
        B, dev = batch_size, generator.device
        lo, hi = self.target_radius
        return {
            "tilt": torch.randn((B, 3), generator=generator, device=dev),
            "qvel_noise": torch.randn((B, self.model.nv), generator=generator, device=dev),
            "target_dir": torch.randn((B, 3), generator=generator, device=dev),
            "target_radius": lo + (hi - lo) * torch.rand(B, generator=generator, device=dev),
        }

    # -- helpers -------------------------------------------------------------

    def _ee_pos(self, qpos: torch.Tensor) -> torch.Tensor:
        """End-effector position relative to the shoulder anchor."""
        anchor = torch.tensor([0.0, 0.0, SHOULDER_HEIGHT], device=qpos.device)
        return end_effector_position(self.model, qpos) - anchor

    def _obs(self, q: dict, ee: torch.Tensor) -> torch.Tensor:
        qpos, qvel = q["qpos"], q["qvel"]
        return torch.cat(
            [
                qpos[:, 0:4],  # shoulder quaternion
                qvel[:, 0:3],  # shoulder ω (child frame)
                qpos[:, 4:5],  # elbow angle
                qvel[:, 3:4],  # elbow rate
                ee,
                q["target"],
                q["target"] - ee,
            ],
            dim=-1,
        )

    def _state(self, q: dict, action: torch.Tensor) -> State:
        ee = self._ee_pos(q["qpos"])
        dist = torch.linalg.norm(q["target"] - ee, dim=-1)
        reward = torch.exp(-((dist / self.sigma) ** 2)) - self.ctrl_cost * torch.sum(
            torch.square(action), dim=-1
        )
        return State(
            data=q,
            obs=self._obs(q, ee),
            reward=reward,
            done=torch.zeros_like(dist),  # fixed-horizon; EpisodeWrapper truncates
            info={},
            metrics={"ee_distance": dist},
        )

    def render(self, trajectory, height: int = 240, width: int = 320) -> list:
        """Rasterize a trajectory of (Slim)States, one env each, into HWC
        uint8 frames (JAX ``reacher.py:130-185``): side view, the camera
        fixed at the shoulder; the arm's segments, the end effector and
        the episode's target as a crosshair."""
        scale = height / 1.6
        cx, cy = width // 2, height // 2

        def to_px(x, z):
            # Shoulder-relative coords; x right, z up.
            return int(cx + x * scale), int(cy - z * scale)

        frames = []
        anchor = np.array([0.0, 0.0, SHOULDER_HEIGHT], np.float32)
        ps_all, Es_all = body_frames(self.model, [slim.data["qpos"] for slim in trajectory])
        for slim, ps, Es in zip(trajectory, ps_all - anchor, Es_all):
            target = np.asarray(slim.data["target"])
            elbow = ps[1]
            tip = ps[1] + Es[1] @ np.asarray(EE_OFFSET, np.float32)

            frame = np.full((height, width, 3), 255, np.uint8)
            # Pedestal mark at the shoulder.
            frame[cy - 2 : cy + 3, cx - 2 : cx + 3, :] = (40, 40, 40)
            draw_line(frame, to_px(0.0, 0.0), to_px(elbow[0], elbow[2]), (60, 60, 60))
            draw_line(frame, to_px(elbow[0], elbow[2]), to_px(tip[0], tip[2]), (60, 60, 60))
            px, py = to_px(tip[0], tip[2])
            if 0 <= px < width - 4 and 0 <= py < height - 4:
                frame[py : py + 4, px : px + 4, :] = (200, 80, 40)
            # Target crosshair.
            tx, ty = to_px(target[0], target[2])
            draw_line(frame, (tx - 5, ty), (tx + 5, ty), (40, 40, 200))
            draw_line(frame, (tx, ty - 5), (tx, ty + 5), (40, 40, 200))
            frames.append(frame)
        return frames

    # -- protocol ------------------------------------------------------------

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        tilt = 0.3 * draws["tilt"]
        B, dev = tilt.shape[0], tilt.device
        rest = torch.tensor(default_qpos(self.model), device=dev).expand(B, -1)
        # A small random shoulder tilt through the exponential map keeps
        # the quaternion valid for any noise draw.
        quat = quat_integrate(rest[:, 0:4], tilt, 1.0)
        direction = draws["target_dir"]
        direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
        q = {
            "qpos": torch.cat([quat, rest[:, 4:]], dim=-1),
            "qvel": 0.05 * draws["qvel_noise"],
            "target": draws["target_radius"][:, None] * direction,
        }
        return self._state(q, torch.zeros((B, self.action_size), device=dev))

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The reacher draws nothing in step; the generator is ignored.
        del generator
        q = state.data
        tau = self.torque_scale * torch.clamp(action, -1.0, 1.0)
        if self._scene_runner is not None:
            qpos, qvel, _ = self._scene_runner(q["qpos"], q["qvel"], tau)
        else:
            qpos, qvel, _ = step(
                self.model, q["qpos"], q["qvel"], tau, self.physics_dt, n_substeps=self.n_substeps
            )
        return self._state({"qpos": qpos, "qvel": qvel, "target": q["target"]}, action)
