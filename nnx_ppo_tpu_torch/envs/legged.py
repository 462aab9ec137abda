"""Generic joystick-locomotion env over the rigid-body step, batched.

Port of ``nnx_ppo_tpu/envs/legged.py`` (``LeggedJoystick`` :162,
``legged_from_mjcf`` :45). One implementation serves every legged model:
velocity-command tracking with dict obs, dict rewards (per-key GAE),
per-substep PD position control (P explicit, D implicit via model joint
damping), command resampling and tilt/height termination. The JAX env
steps one env and is vmapped; this one holds ``[B, ...]`` tensors and
steps all envs at once, on one of three dynamics paths picked at
construction by ``substep_impl`` (JAX's values):

* the control-step runner (``physics/cuda_step.py``): factor and all
  substeps in one launch, the CUDA kernel for CUDA tensors and its plain
  version for CPU tensors; ``reuse_mass_matrix=False`` selects its
  ``exact`` mode (factor rebuilt at every substep). With a ``HeightGrid``
  terrain it first samples each ground geom's tangent plane (the
  plane-sampler kernel) and holds the planes over the control step;
* the substep runner (``pallas_in_kernel_factor=False``): the factor of
  ``M(q) + dt·D`` is built outside the kernel
  (``physics/engine.py::mass_matrix_factor``) once per control step and
  handed to the substeps kernel, ``pallas_substeps_per_kernel`` substeps
  per launch. Flat ground, no randomization, no pushes, held factor only;
* the generic engine (``physics/engine.py::forward_dynamics`` and
  ``integrate``, eager PyTorch; JAX ``legged.py:760-810``): PD recomputed
  every substep, the push as an ``external_forces`` point force at the
  trunk origin, the factor held over the control step under
  ``reuse_mass_matrix``, domain-randomization ``params`` and terrain.

``substep_impl="auto"`` takes a runner when the model and its features
are supported (``engine_soa.soa_unsupported_reason``) and otherwise the
generic engine; ``"pallas"`` takes a runner or raises JAX's
``ValueError``; ``"xla"`` always takes the generic engine. JAX's
``depthwise=None`` picks its depth-wise engine on ``"xla"`` where the
model allows; the port has no depth-wise engine, so ``None`` and
``False`` both give the generic one (JAX tests the two equal up to
rounding).

Randomness: the JAX env carries a key per env in ``State.data`` and
splits it in ``step``. Here ``reset`` and ``step`` take the caller's one
device ``torch.Generator``, and every draw sits behind one small method
per phase (``_draw_reset``, ``_draw_push``, ``_draw_resample``,
``_draw_obs_noise``), so that a test can inject another package's draws.

``render`` rasterizes a trajectory on the host with numpy (JAX
``legged.py:583-660``). Not ported yet: ``depthwise=True`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from nnx_ppo_tpu_torch.core.device import DeviceConstants
from nnx_ppo_tpu_torch.envs.raster import body_frames, draw_line
from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.physics import soa
from nnx_ppo_tpu_torch.physics.cuda_step import make_control_step_runner, make_substep_runner
from nnx_ppo_tpu_torch.physics.engine import forward_dynamics, integrate, mass_matrix_factor
from nnx_ppo_tpu_torch.physics.engine_soa import (
    soa_features_unsupported_reason,
    soa_unsupported_reason,
)
from nnx_ppo_tpu_torch.physics.model import Model
from nnx_ppo_tpu_torch.physics.randomize import DomainParams, privileged_vector
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, Terrain


def legged_from_mjcf(
    xml,
    *,
    kp: Optional[float] = None,
    action_scale=None,
    n_feet: Optional[int] = None,
    default_pose=None,
    stand_height: Optional[float] = None,
    contact_stiffness: float = 6_000.0,
    contact_damping: float = 120.0,
    model_overrides: Optional[dict] = None,
    **env_kwargs,
) -> "LeggedJoystick":
    """Build a :class:`LeggedJoystick` directly from a MuJoCo MJCF robot
    description (``nnx_ppo_tpu/envs/legged.py:45``; ``physics/mjcf.py``,
    which needs ``mujoco``).

    The MJCF supplies what it knows best, the caller overrides the rest:

    * model, contact spheres and collision pairs, imported as usual (the
      XML must declare a z = 0 floor plane, or a world hfield);
    * default pose and stand height from the MJCF reference configuration
      (``qpos0``): joint segment and base z; override with
      ``default_pose=`` / ``stand_height=`` when the nominal stance
      differs from the declared zero configuration;
    * ``kp`` from ``<position>`` actuators (their mean P-gain); their
      D-gains (``kv``) fold into the model's implicit joint damping;
    * ``action_scale``: per-joint half-widths of the position actuators'
      ctrlranges when they cover every joint, else the caller's scalar;
    * ``n_feet``: how many leading contact geoms are feet (contact
      metrics only), all imported geoms by default;
    * an imported hfield becomes the env's ``terrain``.

    Everything else (``terrain=``, ``randomize=``, ``reuse_mass_matrix=``,
    ``substep_impl=``, ...) passes through to :class:`LeggedJoystick`.
    """
    from nnx_ppo_tpu_torch.physics.mjcf import from_mjcf

    imp = from_mjcf(
        xml,
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        # Extra Model fields (friction_vel, max_contact_force,
        # limit_stiffness, ...): light robots need softer contacts.
        **(model_overrides or {}),
    )
    return legged_from_import(
        imp, kp=kp, action_scale=action_scale, n_feet=n_feet, default_pose=default_pose,
        stand_height=stand_height, **env_kwargs,
    )


def legged_from_import(
    imp,
    *,
    kp: Optional[float] = None,
    action_scale=None,
    n_feet: Optional[int] = None,
    default_pose=None,
    stand_height: Optional[float] = None,
    **env_kwargs,
) -> "LeggedJoystick":
    """The part of :func:`legged_from_mjcf` after the import: a
    :class:`LeggedJoystick` from an ``MjcfImport`` (fresh from
    ``from_mjcf``, or rebuilt without ``mujoco`` from a saved import such
    as ``physics/models/mjcf_quadruped.py::load_quadruped_import``). JAX
    ``legged.py:96-160``."""
    model = imp.model
    if not model.free_base:
        raise ValueError("legged_from_mjcf needs a free-base robot")
    if not model.geom_body:
        raise ValueError(
            "no contact spheres imported — the MJCF needs a z = 0 "
            "floor plane and sphere (or capsule) collision geoms"
        )
    if default_pose is None:
        default_pose = np.asarray(imp.qpos0[7:], np.float64)
    if stand_height is None:
        stand_height = float(imp.qpos0[2])
    if imp.terrain is not None and "terrain" not in env_kwargs:
        # A world hfield imported as a HeightGrid becomes the env's
        # ground (spawn heights and rewards measure relative to it).
        env_kwargs["terrain"] = imp.terrain

    position_acts = [a for a in imp.actuators if a.kind == "position"]
    if kp is None:
        if not position_acts:
            raise ValueError("no <position> actuators in the MJCF — pass kp= explicitly")
        kp = float(np.mean([a.kp for a in position_acts]))
    if position_acts and any(a.kv for a in position_acts):
        # Fold actuator D-gains into the per-dof joint damping, which the
        # engine integrates implicitly (how a stiff PD derivative term
        # stays stable).
        damping = np.asarray(model.damping, np.float64).copy()
        for a in position_acts:
            damping[a.dof] += a.kv
        model = dataclasses.replace(model, damping=damping)
    if action_scale is None:
        # Only position actuators' ctrlranges are joint-target ranges (a
        # motor or velocity ctrlrange is a torque or speed limit).
        ranged = [a for a in position_acts if a.ctrlrange is not None and a.dof >= 6]
        covered = {a.dof for a in ranged}
        if ranged and covered == set(range(6, 6 + len(default_pose))):
            scale = np.zeros(len(default_pose))
            for a in ranged:
                scale[a.dof - 6] = 0.5 * (a.ctrlrange[1] - a.ctrlrange[0])
            action_scale = scale
        else:
            action_scale = 0.5

    return LeggedJoystick(
        model,
        default_pose,
        stand_height,
        kp=kp,
        action_scale=action_scale,
        n_feet=(n_feet if n_feet is not None else len(model.geom_body)),
        **env_kwargs,
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
        substep_impl: str = "auto",
        pallas_substeps_per_kernel: int = 1,
        pallas_in_kernel_factor: bool = True,
    ):
        if depthwise:
            raise NotImplementedError(
                "depthwise dynamics are not ported yet; depthwise=None or False "
                "steps the generic engine (or the SoA runners)"
            )
        if substep_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"substep_impl must be 'auto'|'xla'|'pallas', got {substep_impl!r}"
            )
        self.substep_impl = substep_impl
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

        self._dr_fields: tuple = ()
        self._kernel_push = False
        self._control_runner = self._substep_runner = None
        if substep_impl != "xla":
            reason = soa_unsupported_reason(model)
            if reason is None and not reuse_mass_matrix and not pallas_in_kernel_factor:
                # Only the factor-passed-in kernel requires the held factor.
                reason = (
                    "the substep kernel holds the M + dt·D factor over the "
                    "control step — pass reuse_mass_matrix=True"
                )
            if reason is None:
                if pallas_in_kernel_factor:
                    # The control-step runner carries terrain, scalar DR
                    # draws and pushes as extra lanes of the one launch.
                    reason = soa_features_unsupported_reason(terrain=terrain, randomize=randomize)
                elif terrain is not None:
                    reason = "the legacy substep kernel supports the flat z=0 ground only"
                elif randomize is not None:
                    reason = "the legacy substep kernel does not consume per-env DR overrides"
                elif push_force > 0.0:
                    reason = "the legacy substep kernel does not apply external push forces"
            if reason is None:
                if pallas_in_kernel_factor:
                    self._dr_fields = () if randomize is None else tuple(randomize.fields)
                    self._kernel_push = push_force > 0.0
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
            elif substep_impl == "pallas":
                raise ValueError(f"substep_impl='pallas' unsupported: {reason}")
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

    def render(self, trajectory, height: int = 240, width: int = 320) -> list:
        """Rasterize a trajectory of (Slim)States, one env each, into HWC
        uint8 frames (JAX ``legged.py:583-660``): side view, the camera
        tracking the trunk; the flat ground line or the terrain's profile
        along the camera plane, the bones, the contact geoms and a trunk
        marker. The kinematics come from each frame's ``qpos``, all frames
        in one ``fwd_kinematics`` call."""
        model = self.model
        frames = []
        scale = height / 1.6  # ~1.6 m vertical field of view
        ground_y = int(height * 0.92)
        ps_all, Es_all = body_frames(model, [slim.data["qpos"] for slim in trajectory])
        for ps, Es in zip(ps_all, Es_all):
            cam_x = ps[0][0]

            def to_px(x, z):
                return (
                    int(width / 2 + (x - cam_x) * scale),
                    int(ground_y - z * scale),
                )

            frame = np.full((height, width, 3), 255, np.uint8)
            if self.terrain is None:
                frame[ground_y : ground_y + 2, :, :] = 110
            else:
                # Terrain profile along the camera plane (y = trunk y).
                trunk_y = float(ps[0][1])
                wxs = (cam_x + (np.arange(width) - width / 2) / scale).astype(np.float32)
                xy = np.stack([wxs, np.full(width, trunk_y, np.float32)], axis=-1)
                hs = self.terrain.height(torch.from_numpy(xy)).numpy()
                pys = (ground_y - hs * scale).astype(int)
                for px in range(width):
                    py = pys[px]
                    if 0 <= py < height - 2:
                        frame[py : py + 2, px, :] = 110
            for i in range(1, model.n_bodies):
                a = ps[model.parent[i]]
                b = ps[i]
                draw_line(frame, to_px(a[0], a[2]), to_px(b[0], b[2]), (60, 60, 60))
            for g, bidx in enumerate(model.geom_body):
                x = ps[bidx] + Es[bidx] @ np.asarray(model.geom_offset[g], np.float32)
                px, py = to_px(x[0], x[2])
                r = max(int(model.geom_radius[g] * scale), 2)
                y0, y1 = max(py - r, 0), min(py + r, height)
                x0, x1 = max(px - r, 0), min(px + r, width)
                if y0 < y1 and x0 < x1:
                    frame[y0:y1, x0:x1, :] = (200, 80, 40)
            # Trunk marker.
            px, py = to_px(ps[0][0], ps[0][2])
            if 0 <= px < width - 4 and 0 <= py < height - 4:
                frame[py : py + 4, px : px + 4, :] = (40, 40, 200)
            frames.append(frame)
        return frames

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
        # The push: a horizontal world-frame force at the trunk origin,
        # held for the control step (zero when not pushing).
        f_push = None
        if self.push_force > 0.0:
            pushing, theta = push
            magnitude = pushing.to(torch.float32) * self.push_force
            f_push = [magnitude * torch.cos(theta), magnitude * torch.sin(theta), magnitude * 0.0]
        if self._control_runner is None:
            qpos, qvel, foot_normals = self._generic_substeps(q, target, dr, f_push)
            return self._finish_step(q, action, qpos, qvel, foot_normals, resample, noise)

        # DR scalars and the push vector ride along as packed per-env
        # extra lanes of the one control-step launch.
        parts = [getattr(dr, name) for name in self._dr_fields]
        if self._kernel_push:
            parts.extend(f_push)
        if parts:
            qpos, qvel, last_normals = self._control_runner(
                q["qpos"], q["qvel"], target, torch.stack(parts, dim=1)
            )
        else:
            qpos, qvel, last_normals = self._control_runner(q["qpos"], q["qvel"], target)
        return self._finish_step(
            q, action, qpos, qvel, last_normals[:, : self.n_feet], resample, noise
        )

    def _generic_substeps(self, q: dict, target: torch.Tensor, dr: Optional[DomainParams],
                          f_push: Optional[list]) -> tuple:
        """The control step on the generic engine (JAX ``legged.py:760-
        810``): ``(qpos, qvel, the last substep's foot normal forces)``."""
        gain = 1.0 if dr is None or dr.gain_scale is None else dr.gain_scale[:, None]
        chol = None
        if self.reuse_mass_matrix:
            chol = mass_matrix_factor(self.model, q["qpos"], dt=self.physics_dt, params=dr)
        if f_push is not None:
            f_push = torch.stack(f_push, dim=-1)
        qp, qv = q["qpos"], q["qvel"]
        base = torch.zeros((qp.shape[0], 6), device=qp.device)
        normals = None
        for _ in range(self.n_substeps):
            # PD recomputed every substep against the held target (P
            # explicit; D implicit via the model's joint damping).
            tau = torch.cat([base, gain * self.kp * (target - qp[:, 7:])], dim=-1)
            ext = [(0, qp[:, 0:3], f_push)] if f_push is not None else None
            qacc, normals = forward_dynamics(
                self.model, qp, qv, tau, dt=self.physics_dt, chol=chol, terrain=self.terrain,
                params=dr, external_forces=ext,
            )
            qp, qv = integrate(self.model, qp, qv, qacc, self.physics_dt)
        return qp, qv, normals[:, : self.n_feet]

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
