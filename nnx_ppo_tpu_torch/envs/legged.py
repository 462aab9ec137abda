"""Generic joystick-locomotion env over the SoA control step, batched.

Port of ``nnx_ppo_tpu/envs/legged.py`` (``LeggedJoystick`` :162). One
implementation serves every legged model: velocity-command tracking with
dict obs, dict rewards (per-key GAE), per-substep PD position control
(P explicit, D implicit via model joint damping), command resampling and
tilt/height termination. The JAX env steps one env and is vmapped; this
one holds ``[B, ...]`` tensors and steps all envs with one call of a
runner of ``physics/cuda_step.py``: CUDA kernels for CUDA tensors, their
plain versions for CPU tensors. The runners are the only dynamics paths
of the port:

* the control-step runner (default): factor and all substeps in one
  launch; ``reuse_mass_matrix=False`` selects its ``exact`` mode (factor
  rebuilt at every substep). With a ``HeightGrid`` terrain it first
  samples each ground geom's tangent plane (the plane-sampler kernel) and
  holds the planes over the control step;
* the substep runner (``pallas_in_kernel_factor=False``): the factor of
  ``M(q) + dt·D`` is built outside the kernel
  (``physics/engine.py::mass_matrix_factor``) once per control step and
  handed to the substeps kernel, ``pallas_substeps_per_kernel`` substeps
  per launch. Flat ground, no randomization, no pushes, held factor only.

Randomness: the JAX env carries a key per env in ``State.data`` and
splits it in ``step``. Here ``reset`` and ``step`` take the caller's one
device ``torch.Generator``, and every draw sits behind one small method
per phase (``_draw_reset``, ``_draw_push``, ``_draw_resample``,
``_draw_obs_noise``), so that a test can inject another package's draws.

Not ported yet (each raises ``NotImplementedError``):
``legged_from_mjcf``, ``render`` and ``depthwise`` dynamics.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
import torch

from nnx_ppo_tpu_torch.core.device import DeviceConstants
from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.physics import soa
from nnx_ppo_tpu_torch.physics.cuda_step import make_control_step_runner, make_substep_runner
from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
from nnx_ppo_tpu_torch.physics.model import Model
from nnx_ppo_tpu_torch.physics.randomize import DomainParams, privileged_vector
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, Terrain


def legged_from_mjcf(*args: Any, **kwargs: Any):
    """Build a :class:`LeggedJoystick` from a MuJoCo MJCF description
    (``nnx_ppo_tpu/envs/legged.py:45``). Not ported yet."""
    raise NotImplementedError(
        "legged_from_mjcf is not ported yet (the MJCF importer is not part of the port)"
    )


class LeggedJoystick(DeviceConstants):
    """Velocity-command tracking for a PD-actuated legged robot.

    Observation (dict of ``[B, ...]``)::

        {"proprio": [3n+6]  (trunk ω (3) ‖ gravity dir in trunk frame
                             (3) ‖ joint pos − default (n) ‖ joint vel
                             (n) ‖ previous action (n)),
         "command": [3]     (vx*, vy*, ωz* in the trunk frame)}

    plus ``"height_scan"`` (``height_scan=n``: an n×n grid of terrain
    heights around the trunk) and ``"privileged"`` (the episode's
    domain-randomization draw, for an asymmetric critic) when asked for.
    Action: ``[B, n]`` joint-position targets around the default pose.
    Reward: ``{"tracking": [B], "penalty": [B]}`` (per-key GAE).
    """

    def __init__(
        self,
        model: Model,
        default_pose,
        stand_height: float,
        *,
        kp: float,
        action_scale,  # scalar or per-joint [n_act] array
        control_dt: float = 0.02,
        n_substeps: int = 10,
        max_command: tuple[float, float, float] = (1.0, 0.5, 1.5),
        command_resample_prob: float = 0.004,
        tracking_sigma: float = 0.25,
        min_up: float = 0.5,
        min_height: float = 0.12,
        reset_joint_noise: float = 0.1,
        reuse_mass_matrix: bool = False,
        n_feet: int = 4,
        terrain: Union[Terrain, HeightGrid, None] = None,
        spawn_radius: float = 5.0,
        height_scan: int = 0,
        height_scan_extent: float = 0.45,
        randomize=None,
        privileged_obs: bool = False,
        obs_noise: float = 0.0,
        push_prob: float = 0.0,
        push_force: float = 0.0,
        depthwise: Optional[bool] = None,
        pallas_substeps_per_kernel: int = 1,
        pallas_in_kernel_factor: bool = True,
    ):
        if depthwise:
            raise NotImplementedError(
                "depthwise dynamics are not ported yet; the port steps through "
                "the SoA control-step runner only"
            )
        if not pallas_in_kernel_factor:
            # Only the factor-passed-in kernel requires the held factor
            # and the bare feature set; the control-step runner carries
            # terrain, randomization and pushes as extra lanes.
            reason = None
            if not reuse_mass_matrix:
                reason = (
                    "the substep kernel holds the M + dt·D factor over the "
                    "control step — pass reuse_mass_matrix=True"
                )
            elif terrain is not None:
                reason = "the legacy substep kernel supports the flat z=0 ground only"
            elif randomize is not None:
                reason = "the legacy substep kernel does not consume per-env DR overrides"
            elif push_force > 0.0:
                reason = "the legacy substep kernel does not apply external push forces"
            if reason is not None:
                raise ValueError(f"pallas_in_kernel_factor=False unsupported: {reason}")
        self.model = model
        self.default_pose = torch.tensor(np.asarray(default_pose), dtype=torch.float32)
        self.stand_height = stand_height
        self.n_act = int(self.default_pose.shape[0])
        self.kp = kp
        self.action_scale = torch.tensor(np.asarray(action_scale), dtype=torch.float32)
        self.control_dt = control_dt
        self.n_substeps = n_substeps
        self.physics_dt = control_dt / n_substeps
        self.max_command = torch.tensor(max_command, dtype=torch.float32)
        self.command_resample_prob = command_resample_prob
        self.tracking_sigma = tracking_sigma
        self.min_up = min_up
        self.min_height = min_height
        self.reset_joint_noise = reset_joint_noise
        # True: factor M(q) once per control step and hold it over the
        # substeps; False: rebuild it at every substep (exact dynamics).
        self.reuse_mass_matrix = reuse_mass_matrix
        # The first n_feet contact geoms are the foot spheres; their
        # normal forces feed the contact metrics.
        self.n_feet = n_feet
        # Heightfield ground (analytic Terrain or HeightGrid data);
        # per-env variation comes from random spawn positions within
        # spawn_radius.
        self.terrain = terrain
        self.spawn_radius = spawn_radius
        self.height_scan = height_scan
        self.height_scan_extent = height_scan_extent
        if height_scan > 0 and terrain is None:
            raise ValueError("height_scan requires a terrain")
        # Per-env domain randomization, drawn at every reset.
        self.randomize = randomize
        self.privileged_obs = privileged_obs
        if privileged_obs and randomize is None:
            raise ValueError("privileged_obs requires randomize=")
        # Sensor noise: zero-mean Gaussian of this std on the proprio and
        # height_scan streams; the underlying state stays clean.
        self.obs_noise = obs_noise
        # Random pushes: with probability push_prob per control step, a
        # horizontal force of push_force N in a uniform-random heading at
        # the trunk origin for the whole control step.
        self.push_prob = push_prob
        self.push_force = push_force

        self._dr_fields: tuple = () if randomize is None else tuple(randomize.fields)
        self._kernel_push = push_force > 0.0
        self._control_runner = self._substep_runner = None
        if pallas_in_kernel_factor:
            self._control_runner = make_control_step_runner(
                model, kp, self.physics_dt, n_substeps,
                exact=not reuse_mass_matrix,
                terrain=terrain,
                dr_fields=self._dr_fields,
                has_push=self._kernel_push,
            )
        else:
            self._substep_runner = make_substep_runner(
                model, kp, self.physics_dt, n_substeps,
                substeps_per_kernel=pallas_substeps_per_kernel,
            )
        self.observation_size = {"proprio": 3 * self.n_act + 6, "command": 3}
        if height_scan > 0:
            lin = torch.linspace(-height_scan_extent, height_scan_extent, height_scan)
            gx, gy = torch.meshgrid(lin, lin, indexing="ij")
            # [n², 2] trunk-frame offsets
            self._scan_points = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
            self.observation_size["height_scan"] = height_scan * height_scan
        if privileged_obs:
            self.observation_size["privileged"] = randomize.dim
        self.action_size = self.n_act
        self._identity_quat = torch.tensor([1.0, 0.0, 0.0, 0.0])

    # -- draws (one method per phase) --------------------------------------

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """Everything ``reset`` draws: ``joint_noise[B, n]`` and
        ``qvel_noise[B, nv]`` (unit normal), ``command[B, 3]`` and
        ``spawn[B, 2]`` (uniform in [-1, 1]), ``dr`` (a DomainParams
        draw) and ``obs_noise``."""
        B, dev = batch_size, generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def uniform(*shape):
            return 2.0 * torch.rand(shape, generator=generator, device=dev) - 1.0

        draws = {
            "joint_noise": normal(B, self.n_act),
            "qvel_noise": normal(B, self.model.nv),
            "command": uniform(B, 3),
        }
        if self.terrain is not None:
            draws["spawn"] = uniform(B, 2)
        if self.randomize is not None:
            draws["dr"] = self.randomize.sample(B, generator)
        draws["obs_noise"] = self._draw_obs_noise(B, generator)
        return draws

    def _draw_push(self, batch_size: int, generator: torch.Generator):
        """``(pushing[B] bool, heading[B] in [0, 2π))`` of one step."""
        dev = generator.device
        pushing = torch.rand(batch_size, generator=generator, device=dev) < self.push_prob
        theta = 2.0 * math.pi * torch.rand(batch_size, generator=generator, device=dev)
        return pushing, theta

    def _draw_resample(self, batch_size: int, generator: torch.Generator):
        """``(resample[B] bool, command[B, 3] uniform in [-1, 1])``."""
        dev = generator.device
        resample = (
            torch.rand(batch_size, generator=generator, device=dev) < self.command_resample_prob
        )
        command = 2.0 * torch.rand((batch_size, 3), generator=generator, device=dev) - 1.0
        return resample, command

    def _draw_obs_noise(self, batch_size: int, generator: torch.Generator) -> Optional[dict]:
        """Unit-normal noise per noisy obs stream (``None`` when off)."""
        if self.obs_noise <= 0.0:
            return None
        dev = generator.device
        noise = {
            "proprio": torch.randn(
                (batch_size, self.observation_size["proprio"]), generator=generator, device=dev
            )
        }
        if self.height_scan > 0:
            noise["height_scan"] = torch.randn(
                (batch_size, self.height_scan**2), generator=generator, device=dev
            )
        return noise

    # -- helpers -------------------------------------------------------------

    def _ground_height(self, xy: torch.Tensor) -> torch.Tensor:
        if self.terrain is None:
            return torch.zeros(xy.shape[:-1], device=xy.device)
        return self.terrain.height(xy)

    def _height_scan_obs(self, qpos: torch.Tensor) -> torch.Tensor:
        """Trunk height above each yaw-aligned sample point, minus the
        nominal stand height (``[B, n²]``; 0 on flat ground at stand
        height)."""
        qw, qx, qy, qz = qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6]
        yaw = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
        c, s = torch.cos(yaw), torch.sin(yaw)
        R = torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
        offsets = self._on(qpos.device, "_scan_points") @ R.transpose(-1, -2)  # [B, n², 2]
        hs = self.terrain.height(qpos[:, None, 0:2] + offsets)
        return qpos[:, 2:3] - hs - self.stand_height

    def _up_row(self, qpos: torch.Tensor) -> tuple:
        """Third row of ``world_R_trunk``: the world up axis in trunk
        coordinates (``Eᵀ @ [0, 0, 1]``)."""
        return soa.quat_to_m3(qpos[:, 3:7].unbind(-1))[6:9]

    def _obs(self, q: dict, noise: Optional[dict] = None) -> dict:
        qpos, qvel = q["qpos"], q["qvel"]
        gravity_dir = -torch.stack(self._up_row(qpos), dim=-1)
        proprio = torch.cat(
            [
                qvel[:, 0:3],  # trunk angular velocity (body frame)
                gravity_dir,
                qpos[:, 7:] - self._on(qpos.device, "default_pose"),
                qvel[:, 6:],
                q["prev_action"],
            ],
            dim=-1,
        )
        obs = {"proprio": proprio, "command": q["cmd"]}
        if self.height_scan > 0:
            obs["height_scan"] = self._height_scan_obs(qpos)
        if self.obs_noise > 0.0:
            # Sensor noise on the measured streams; the command and the
            # privileged stream stay clean.
            obs["proprio"] = obs["proprio"] + self.obs_noise * noise["proprio"]
            if self.height_scan > 0:
                obs["height_scan"] = obs["height_scan"] + self.obs_noise * noise["height_scan"]
        if self.privileged_obs:
            obs["privileged"] = privileged_vector(q["dr"])
        return obs

    def _reward(self, q: dict, action: torch.Tensor, prev_action: torch.Tensor) -> dict:
        qpos, qvel = q["qpos"], q["qvel"]
        # Body-frame planar/yaw velocity tracking.
        v_body = qvel[:, 3:6]
        w_body = qvel[:, 0:3]
        cmd = q["cmd"]
        lin_err = torch.sum(torch.square(cmd[:, :2] - v_body[:, :2]), dim=-1)
        ang_err = torch.square(cmd[:, 2] - w_body[:, 2])
        r_lin = torch.exp(-lin_err / self.tracking_sigma)
        r_ang = torch.exp(-ang_err / self.tracking_sigma)
        tracking = 0.7 * r_lin + 0.3 * r_ang

        up_alignment = self._up_row(qpos)[2]  # 1 = level
        height = qpos[:, 2] - self._ground_height(qpos[:, 0:2])
        penalty = (
            0.002 * torch.sum(torch.square(action), dim=-1)
            + 0.01 * torch.sum(torch.square(action - prev_action), dim=-1)
            + 0.05 * torch.square(height - self.stand_height)
            + 0.02 * (1.0 - up_alignment)
        )
        return {"tracking": tracking, "penalty": -penalty}

    def _done(self, q: dict) -> torch.Tensor:
        qpos = q["qpos"]
        up = self._up_row(qpos)[2]
        height = qpos[:, 2] - self._ground_height(qpos[:, 0:2])
        fallen = (up < self.min_up) | (height < self.min_height)
        return fallen.to(torch.float32)

    def _state(
        self,
        q: dict,
        action: torch.Tensor,
        prev_action: torch.Tensor,
        foot_normals: Optional[torch.Tensor] = None,
        noise: Optional[dict] = None,
    ) -> State:
        # foot_normals: per-foot ground normal forces [B, n_feet] of the
        # last physics substep (zeros at reset).
        qpos = q["qpos"]
        if foot_normals is None:
            foot_normals = torch.zeros((qpos.shape[0], self.n_feet), device=qpos.device)
        return State(
            data=q,
            obs=self._obs(q, noise),
            reward=self._reward(q, action, prev_action),
            done=self._done(q),
            info={},
            metrics={
                "trunk_height": qpos[:, 2] - self._ground_height(qpos[:, 0:2]),
                "speed": torch.linalg.norm(q["qvel"][:, 3:5], dim=-1),
                # Count of foot contact spheres touching the ground.
                "foot_contacts": torch.sum((foot_normals > 0.0).to(torch.float32), dim=-1),
                "contact_force": torch.sum(foot_normals, dim=-1),
            },
        )

    def render(self, trajectory, height: int = 240, width: int = 320):
        """Rasterize a trajectory into frames
        (``nnx_ppo_tpu/envs/legged.py:583``). Not ported yet."""
        raise NotImplementedError("LeggedJoystick.render is not ported yet")

    # -- protocol ------------------------------------------------------------

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        joint_noise = self.reset_joint_noise * draws["joint_noise"]
        B, dev = joint_noise.shape[0], joint_noise.device
        if self.terrain is None:
            spawn_xy = torch.zeros((B, 2), device=dev)
        else:
            # Random world position = per-env local terrain.
            spawn_xy = self.spawn_radius * draws["spawn"]
        spawn_z = self.stand_height + self._ground_height(spawn_xy)
        identity_quat = self._on(dev, "_identity_quat").expand(B, 4)
        qpos = torch.cat(
            [spawn_xy, spawn_z[:, None], identity_quat, self._on(dev, "default_pose") + joint_noise],
            dim=-1,
        )
        q = {
            "qpos": qpos,
            "qvel": 0.05 * draws["qvel_noise"],
            "cmd": self._on(dev, "max_command") * draws["command"],
            "prev_action": torch.zeros((B, self.n_act), device=dev),
        }
        if self.randomize is not None:
            q["dr"] = draws["dr"]
        zero = torch.zeros((B, self.n_act), device=dev)
        return self._state(q, zero, zero, noise=draws["obs_noise"])

    def step(
        self, state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> State:
        if generator is None:
            raise ValueError(
                "LeggedJoystick.step draws (command resampling, pushes, sensor "
                "noise): pass the run's generator"
            )
        B = action.shape[0]
        push = self._draw_push(B, generator) if self.push_force > 0.0 else None
        resample = self._draw_resample(B, generator)
        noise = self._draw_obs_noise(B, generator)
        return self._step_from(state, action, push, resample, noise)

    def _step_from(self, state: State, action: torch.Tensor, push, resample, noise) -> State:
        q = state.data
        dev = action.device
        action = torch.clamp(action, -1.0, 1.0)
        target = self._on(dev, "default_pose") + self._on(dev, "action_scale") * action
        if self._substep_runner is not None:
            # The factor of M(q) + dt·D from the pre-substep qpos, built
            # outside the kernel and held over the control step.
            chol = mass_matrix_factor(self.model, q["qpos"], dt=self.physics_dt)
            qpos, qvel, last_normals = self._substep_runner(q["qpos"], q["qvel"], target, chol)
            return self._finish_step(
                q, action, qpos, qvel, last_normals[:, : self.n_feet], resample, noise
            )
        dr: Optional[DomainParams] = q.get("dr") if self.randomize is not None else None

        # DR scalars and the push vector ride along as packed per-env
        # extra lanes of the one control-step launch.
        parts = [getattr(dr, name) for name in self._dr_fields]
        if self._kernel_push:
            pushing, theta = push
            magnitude = pushing.to(torch.float32) * self.push_force
            parts.extend(
                [magnitude * torch.cos(theta), magnitude * torch.sin(theta),
                 magnitude * 0.0]
            )
        if parts:
            qpos, qvel, last_normals = self._control_runner(
                q["qpos"], q["qvel"], target, torch.stack(parts, dim=1)
            )
        else:
            qpos, qvel, last_normals = self._control_runner(q["qpos"], q["qvel"], target)
        return self._finish_step(
            q, action, qpos, qvel, last_normals[:, : self.n_feet], resample, noise
        )

    def _finish_step(self, q, action, qpos, qvel, last_foot_normals, resample, noise) -> State:
        """Post-substep tail: command resampling and state assembly."""
        resample_now, command = resample
        cmd = torch.where(
            resample_now[:, None], self._on(qpos.device, "max_command") * command, q["cmd"]
        )
        new_q = {"qpos": qpos, "qvel": qvel, "cmd": cmd, "prev_action": action}
        if self.randomize is not None:
            new_q["dr"] = q["dr"]  # the draw is per episode; reset resamples
        return self._state(
            new_q, action, q["prev_action"], foot_normals=last_foot_normals, noise=noise
        )
