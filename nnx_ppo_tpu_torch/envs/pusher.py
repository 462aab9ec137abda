"""Object manipulation: push a free ball to a ground target, batched.

Port of ``nnx_ppo_tpu/envs/pusher.py`` (``ArmPush`` :49). The multi-tree
scene workload (``physics/scene.py``): the ball-shoulder arm (tree 0) and
a free rolling ball (tree 1) interact only through the cross-tree sphere
contact between the end effector and the ball, the contact force the
policy must learn to aim. The JAX env steps one env and is vmapped; this
one holds ``[B, ...]`` tensors and advances all envs at once.
``substep_impl`` takes JAX's values (``pusher.py:71-114``): ``"auto"``
and ``"pallas"`` step through the scene control-step runner
(``physics/cuda_scene_step.py``): arm, ball and their cross contact, all
substeps of a control step in one launch of the CUDA kernel for CUDA
tensors, the plain version for CPU tensors; ``"xla"`` through
``scene.scene_step`` on the generic engine (eager PyTorch, JAX
``pusher.py:262-285``).

Randomness: ``reset`` takes the caller's device ``torch.Generator``; every
draw sits behind ``_draw_reset`` so that a test can inject another
package's draws through ``_reset_from``. ``step`` draws nothing.

``render`` rasterizes a trajectory on the host with numpy (JAX
``pusher.py:163``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nnx_ppo_tpu_torch.envs.raster import body_frames, draw_line
from nnx_ppo_tpu_torch.envs.reacher import end_effector_position
from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.physics.cuda_scene_step import make_scene_control_step_runner
from nnx_ppo_tpu_torch.physics.model import FREE, Model, ModelBuilder
from nnx_ppo_tpu_torch.physics.models.arm import EE_OFFSET, make_arm
from nnx_ppo_tpu_torch.physics.scene import Scene, scene_step
from nnx_ppo_tpu_torch.physics.spatial import quat_integrate

BALL_RADIUS = 0.08
SHOULDER_HEIGHT = 0.55


def _make_ball() -> Model:
    b = ModelBuilder(gravity=-9.81)
    b.add_body(
        "ball",
        joint=FREE,
        mass=0.5,
        inertia=(2.0 / 5.0 * 0.5 * BALL_RADIUS**2,) * 3,
    )
    b.add_sphere_geom("ball", (0.0, 0.0, 0.0), BALL_RADIUS)
    # friction_vel / max_contact_force keep the explicit friction term
    # stable when the light free ball takes violent hits: the viscous
    # slope μ·fn_max/friction_vel must satisfy slope·dt/m_eff < 2 for
    # the smallest effective contact mass (the ball vs the forearm tip,
    # m_eff ≈ 0.06 kg at dt = 1.25 ms → slope < 96 N/(m/s)).
    return b.finalize(
        contact_stiffness=3_000.0,
        contact_damping=50.0,
        friction=0.6,
        friction_vel=1.0,
        max_contact_force=80.0,
    )


class ArmPush:
    """Push the ball to a 2-D ground target with the arm's end effector.

    Observation ``[B, 22]``: shoulder quaternion (4) ‖ shoulder ω (3) ‖
    elbow angle/rate (2) ‖ end effector (3) ‖ ball (3) ‖ ball velocity
    (3) ‖ target xy (2) ‖ target − ball xy (2), positions relative to
    the arm base on the ground. Action ``[B, 4]``: torques. Reward:
    ``exp(-(d_ball→target/σ)²) + 0.3·exp(-(d_ee→ball/σ)²) − ctrl``.
    """

    observation_size: int = 22
    action_size: int = 4

    def __init__(
        self,
        torque_scale: float = 6.0,
        sigma_target: float = 0.12,
        sigma_reach: float = 0.15,
        ctrl_cost: float = 0.005,
        control_dt: float = 0.02,
        n_substeps: int = 16,
        target_radius: tuple[float, float] = (0.25, 0.45),
        substep_impl: str = "auto",
    ):
        arm = make_arm(
            shoulder_height=SHOULDER_HEIGHT,
            friction_vel=1.0,
            max_contact_force=60.0,
        )
        ball = _make_ball()
        # Cross-tree contact: end-effector sphere (arm geom 0) vs ball.
        self.scene = Scene(models=(arm, ball), pairs=((0, 0, 1, 0),))
        self.torque_scale = torque_scale
        self.sigma_target = sigma_target
        self.sigma_reach = sigma_reach
        self.ctrl_cost = ctrl_cost
        self.control_dt = control_dt
        self.n_substeps = n_substeps
        self.physics_dt = control_dt / n_substeps
        self.target_radius = target_radius
        if substep_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"substep_impl must be 'auto'|'xla'|'pallas', got {substep_impl!r}"
            )
        self.substep_impl = substep_impl
        # Arm + ball + their cross contact, all substeps of a control
        # step in one kernel launch, or (None) scene_step's substeps.
        self._scene_runner = None
        if substep_impl != "xla":
            self._scene_runner = make_scene_control_step_runner(
                self.scene.models, self.scene.pairs, self.physics_dt, n_substeps
            )

    # -- draws ---------------------------------------------------------------

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """Everything ``reset`` draws: ``tilt[B, 3]`` (unit normal),
        ``ball_angle[B]`` and ``target_angle[B]`` (uniform in [0, 2π)),
        ``ball_radius[B]`` (uniform in [0.15, 0.3)) and
        ``target_radius[B]`` (uniform over ``self.target_radius``)."""
        B, dev = batch_size, generator.device

        def uniform(lo: float, hi: float) -> torch.Tensor:
            return lo + (hi - lo) * torch.rand(B, generator=generator, device=dev)

        return {
            "tilt": torch.randn((B, 3), generator=generator, device=dev),
            "ball_angle": uniform(0.0, 2.0 * math.pi),
            "ball_radius": uniform(0.15, 0.3),
            "target_angle": uniform(0.0, 2.0 * math.pi),
            "target_radius": uniform(*self.target_radius),
        }

    # -- helpers -------------------------------------------------------------

    def _ee_pos(self, arm_qpos: torch.Tensor) -> torch.Tensor:
        return end_effector_position(self.scene.models[0], arm_qpos)

    def _obs(self, q: dict, ee: torch.Tensor) -> torch.Tensor:
        ball = q["ball_qpos"][:, 0:3]
        return torch.cat(
            [
                q["arm_qpos"][:, 0:4],
                q["arm_qvel"][:, 0:3],
                q["arm_qpos"][:, 4:5],
                q["arm_qvel"][:, 3:4],
                ee,
                ball,
                q["ball_qvel"][:, 3:6],
                q["target"],
                q["target"] - ball[:, 0:2],
            ],
            dim=-1,
        )

    def _state(self, q: dict, action: torch.Tensor) -> State:
        ee = self._ee_pos(q["arm_qpos"])
        ball = q["ball_qpos"][:, 0:3]
        d_bt = torch.linalg.norm(q["target"] - ball[:, 0:2], dim=-1)
        d_eb = torch.linalg.norm(ball - ee, dim=-1)
        reward = (
            torch.exp(-((d_bt / self.sigma_target) ** 2))
            + 0.3 * torch.exp(-((d_eb / self.sigma_reach) ** 2))
            - self.ctrl_cost * torch.sum(torch.square(action), dim=-1)
        )
        # Terminate when the ball is knocked out of the workspace: the
        # episode carries no further signal and auto-reset restores a
        # fresh scene.
        escaped = torch.linalg.norm(ball[:, 0:2], dim=-1) > 2.0
        return State(
            data=q,
            obs=self._obs(q, ee),
            reward=reward,
            done=escaped.to(torch.float32),
            info={},
            metrics={"ball_to_target": d_bt, "ee_to_ball": d_eb},
        )

    def render(self, trajectory, height: int = 240, width: int = 320) -> list:
        """Rasterize a trajectory of (Slim)States, one env each, into HWC
        uint8 frames (JAX ``pusher.py:163-235``): top-down view centred on
        the arm's base; the arm's segments projected to the ground plane,
        the end effector, the ball (a disk, to scale) and the target as a
        crosshair."""
        scale = min(height, width) / 1.8  # ~0.9 m half-extent
        cx, cy = width // 2, height // 2

        def to_px(x, y):
            # World xy -> screen: x right, y up.
            return int(cx + x * scale), int(cy - y * scale)

        arm = self.scene.models[0]
        frames = []
        ps_all, Es_all = body_frames(arm, [slim.data["arm_qpos"] for slim in trajectory])
        for slim, ps, Es in zip(trajectory, ps_all, Es_all):
            elbow = ps[1]
            tip = ps[1] + Es[1] @ np.asarray(EE_OFFSET, np.float32)
            ball = np.asarray(slim.data["ball_qpos"])[0:3]
            target = np.asarray(slim.data["target"])

            frame = np.full((height, width, 3), 255, np.uint8)
            # Base mark.
            frame[cy - 2 : cy + 3, cx - 2 : cx + 3, :] = (40, 40, 40)
            draw_line(frame, to_px(0.0, 0.0), to_px(elbow[0], elbow[1]), (60, 60, 60))
            draw_line(frame, to_px(elbow[0], elbow[1]), to_px(tip[0], tip[1]), (60, 60, 60))
            px, py = to_px(tip[0], tip[1])
            if 0 <= px < width - 4 and 0 <= py < height - 4:
                frame[py : py + 4, px : px + 4, :] = (200, 80, 40)
            # Ball, drawn to scale.
            bx, by = to_px(ball[0], ball[1])
            r = max(int(BALL_RADIUS * scale), 2)
            yy, xx = np.ogrid[-r : r + 1, -r : r + 1]
            for dy_i, dx_i in zip(*np.nonzero(yy * yy + xx * xx <= r * r)):
                yq, xq = by - r + dy_i, bx - r + dx_i
                if 0 <= yq < height and 0 <= xq < width:
                    frame[yq, xq, :] = (80, 140, 60)
            # Target crosshair.
            tx, ty = to_px(target[0], target[1])
            draw_line(frame, (tx - 5, ty), (tx + 5, ty), (40, 40, 200))
            draw_line(frame, (tx, ty - 5), (tx, ty + 5), (40, 40, 200))
            frames.append(frame)
        return frames

    # -- protocol ------------------------------------------------------------

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        tilt = 0.2 * draws["tilt"]
        B, dev = tilt.shape[0], tilt.device
        identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(B, 4)
        quat = quat_integrate(identity, tilt, 1.0)

        def on_circle(radius: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
            return radius[:, None] * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)

        # The ball spawns on the ground within easy reach, never under
        # the hanging end effector.
        ball_xy = on_circle(draws["ball_radius"], draws["ball_angle"])
        q = {
            "arm_qpos": torch.cat([quat, torch.zeros((B, 1), device=dev)], dim=-1),
            "arm_qvel": torch.zeros((B, 4), device=dev),
            "ball_qpos": torch.cat(
                [ball_xy, torch.full((B, 1), BALL_RADIUS, device=dev), identity], dim=-1
            ),
            "ball_qvel": torch.zeros((B, 6), device=dev),
            "target": on_circle(draws["target_radius"], draws["target_angle"]),
        }
        return self._state(q, torch.zeros((B, self.action_size), device=dev))

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The pusher draws nothing in step; the generator is ignored.
        del generator
        q = state.data
        arm = self.scene.models[0]
        tau = self.torque_scale * torch.clamp(action, -1.0, 1.0)
        if self._scene_runner is not None:
            qp, qv, _ = self._scene_runner(
                torch.cat([q["arm_qpos"], q["ball_qpos"]], dim=-1),
                torch.cat([q["arm_qvel"], q["ball_qvel"]], dim=-1),
                torch.cat([tau, torch.zeros_like(q["ball_qvel"])], dim=-1),
            )
        else:
            qps, qvs, _ = scene_step(
                self.scene,
                (q["arm_qpos"], q["ball_qpos"]),
                (q["arm_qvel"], q["ball_qvel"]),
                (tau, torch.zeros_like(q["ball_qvel"])),
                self.physics_dt,
                n_substeps=self.n_substeps,
            )
            qp, qv = torch.cat(qps, dim=-1), torch.cat(qvs, dim=-1)
        ball_qvel = qv[:, arm.nv :]
        # Velocity clamps: the penalty contacts are explicit, and a
        # worst-case adversarial action sequence can drive the
        # light-ball/thin-forearm contact pair into its marginal
        # stability region; bound the state so a pathological hit
        # saturates instead of compounding. Ordinary dynamics sit far
        # below these bounds.
        new_q = {
            "arm_qpos": qp[:, : arm.nq],
            "arm_qvel": torch.clamp(qv[:, : arm.nv], -30.0, 30.0),
            "ball_qpos": qp[:, arm.nq :],
            "ball_qvel": torch.cat(
                [
                    torch.clamp(ball_qvel[:, 0:3], -150.0, 150.0),  # ω
                    torch.clamp(ball_qvel[:, 3:6], -20.0, 20.0),  # v
                ],
                dim=-1,
            ),
            "target": q["target"],
        }
        return self._state(new_q, action)
