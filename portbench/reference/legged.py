"""The legged joystick task of the reference, batched over envs: a
velocity command to track with a PD-driven quadruped on rough analytic
ground, with per-episode domain randomization, random pushes, command
resampling, tilt and height termination, a time limit and auto-reset.

Written from the task's definition (JAX package ``envs/legged.py``,
``wrappers/episode_wrapper.py``); the physics is the frozen lane math
of ``physics/``. The state is one flat dict of ``[B, ...]`` tensors,
keyed as the benchmark compares it. Every draw is taken from the
caller's generator in the task's order, so a generator in a given state
gives the same episode as the program's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.physics import soa
from portbench.reference.physics.engine_soa import crba_chol_soa, substep_soa
from portbench.reference.physics.quadruped import (
    DEFAULT_JOINT_POSE,
    STAND_HEIGHT,
    make_quadruped,
)

DR_FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")


@dataclasses.dataclass(frozen=True)
class Terrain:
    """An analytic heightfield: a sum of sine waves."""

    amplitudes: tuple
    frequencies: tuple
    directions: tuple
    phases: tuple
    slope: tuple = (0.0, 0.0)

    def height(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.slope[0] * x + self.slope[1] * y
        for a, f, d, p in zip(self.amplitudes, self.frequencies, self.directions, self.phases):
            h = h + a * torch.sin(f * (d[0] * x + d[1] * y) + p)
        return h


def rough_terrain(seed: int, amplitude: float, wavelength: float, n_waves: int = 6) -> Terrain:
    """Isotropic rough ground: ``n_waves`` waves of random heading, with
    wavelengths in ``[wavelength, 2 wavelength]`` and a height std of
    about ``amplitude``, drawn by ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    angles = rng.uniform(0.0, 2.0 * math.pi, n_waves)
    lengths = rng.uniform(wavelength, 2.0 * wavelength, n_waves)
    a = amplitude * math.sqrt(2.0 / n_waves)
    return Terrain(
        amplitudes=tuple(float(a) for _ in range(n_waves)),
        frequencies=tuple(float(2.0 * math.pi / L) for L in lengths),
        directions=tuple((float(math.cos(t)), float(math.sin(t))) for t in angles),
        phases=tuple(float(p) for p in rng.uniform(0, 2 * math.pi, n_waves)),
    )


class LeggedTask:
    """The task at the sizes of a configuration dict (``cfg["env"]``)."""

    def __init__(self, env_cfg: dict, device):
        self.cfg = env_cfg
        self.model = make_quadruped()
        self.n_act = len(DEFAULT_JOINT_POSE)
        self.kp = float(env_cfg["kp"])
        self.action_scale = float(env_cfg["action_scale"])
        self.dt = float(env_cfg["control_dt"]) / int(env_cfg["n_substeps"])
        self.n_substeps = int(env_cfg["n_substeps"])
        self.max_command = torch.tensor(env_cfg["max_command"], dtype=torch.float32, device=device)
        self.default_pose = torch.tensor(DEFAULT_JOINT_POSE, dtype=torch.float32, device=device)
        self.terrain = rough_terrain(**env_cfg["terrain"])
        self.dr = {k: tuple(v) for k, v in env_cfg["domain_randomization"].items()}
        self.dr_fields = tuple(k for k in DR_FIELDS if k in self.dr)
        self.device = device

    # -- draws, in the task's order --------------------------------------

    def _reset_draws(self, B: int, gen: torch.Generator) -> dict:
        dev = self.device
        d = {
            "joint_noise": torch.randn((B, self.n_act), generator=gen, device=dev),
            "qvel_noise": torch.randn((B, self.model.nv), generator=gen, device=dev),
            "command": 2.0 * torch.rand((B, 3), generator=gen, device=dev) - 1.0,
            "spawn": 2.0 * torch.rand((B, 2), generator=gen, device=dev) - 1.0,
        }
        for name in self.dr_fields:
            lo, hi = self.dr[name]
            d[name] = lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)
        d["step_counter"] = torch.randint(0, self.cfg["episode_length"] // 2, (B,), generator=gen,
                                          device=dev, dtype=torch.int32)
        return d

    # -- the task ----------------------------------------------------------

    def _up(self, qpos):
        """The world up axis in trunk coordinates."""
        return soa.quat_to_m3(qpos[:, 3:7].unbind(-1))[6:9]

    def _derived(self, s: dict, action, prev_action, normals) -> dict:
        """Observation, reward, done and metrics of a physical state."""
        qpos, qvel, cmd = s["qpos"], s["qvel"], s["cmd"]
        up = self._up(qpos)
        s["obs.proprio"] = torch.cat(
            [qvel[:, 0:3], -torch.stack(up, dim=-1), qpos[:, 7:] - self.default_pose,
             qvel[:, 6:], s["prev_action"]], dim=-1)
        s["obs.command"] = cmd
        lin_err = torch.sum(torch.square(cmd[:, :2] - qvel[:, 3:5]), dim=-1)
        ang_err = torch.square(cmd[:, 2] - qvel[:, 2])
        sigma = self.cfg["tracking_sigma"]
        s["reward.tracking"] = 0.7 * torch.exp(-lin_err / sigma) + 0.3 * torch.exp(-ang_err / sigma)
        height = qpos[:, 2] - self.terrain.height(qpos[:, 0], qpos[:, 1])
        penalty = (
            0.002 * torch.sum(torch.square(action), dim=-1)
            + 0.01 * torch.sum(torch.square(action - prev_action), dim=-1)
            + 0.05 * torch.square(height - STAND_HEIGHT)
            + 0.02 * (1.0 - up[2])
        )
        s["reward.penalty"] = -penalty
        fallen = (up[2] < self.cfg["min_up"]) | (height < self.cfg["min_height"])
        s["fallen"] = fallen
        s["metric.contact_force"] = torch.sum(normals, dim=-1)
        return s

    def reset(self, B: int, gen: torch.Generator) -> dict:
        d = self._reset_draws(B, gen)
        dev = self.device
        spawn_xy = self.cfg["spawn_radius"] * d["spawn"]
        spawn_z = STAND_HEIGHT + self.terrain.height(spawn_xy[:, 0], spawn_xy[:, 1])
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(B, 4)
        s = {
            "qpos": torch.cat([spawn_xy, spawn_z[:, None], quat,
                               self.default_pose + self.cfg["reset_joint_noise"] * d["joint_noise"]],
                              dim=-1),
            "qvel": 0.05 * d["qvel_noise"],
            "cmd": self.max_command * d["command"],
            "prev_action": torch.zeros((B, self.n_act), device=dev),
        }
        for name in self.dr_fields:
            s["dr." + name] = d[name]
        zero = torch.zeros((B, self.n_act), device=dev)
        s = self._derived(s, zero, zero, torch.zeros((B, 4), device=dev))
        s["step_counter"] = d["step_counter"]
        s["truncated"] = torch.zeros(B, dtype=torch.bool, device=dev)
        s["done"] = s.pop("fallen").to(torch.float32)
        return s

    def control_step(self, s: dict, target, push):
        """``n_substeps`` substeps with the factor of ``M + dt D`` built
        from the control step's first state and held."""
        lanes = lambda x: tuple(x.unbind(1))  # noqa: E731
        qp, qv, tgt = lanes(s["qpos"]), lanes(s["qvel"]), lanes(target)
        dr = {name: s["dr." + name] for name in self.dr_fields}
        crba_kw = {k: v for k, v in dr.items() if k in ("mass_scale", "damping_scale")}
        chol = crba_chol_soa(self.model, qp, self.dt, **crba_kw)
        normals = ()
        for _ in range(self.n_substeps):
            qp, qv, normals = substep_soa(self.model, qp, qv, tgt, chol, self.kp, self.dt,
                                          terrain=self.terrain, push=push, **dr)
        return torch.stack(qp, dim=1), torch.stack(qv, dim=1), torch.stack(normals, dim=1)

    def step(self, s: dict, action, gen: torch.Generator, physics=None) -> dict:
        """One control step of every env (no reset). ``physics`` stands in
        for :meth:`control_step` (a captured graph of it)."""
        B, dev = action.shape[0], self.device
        pushing = torch.rand(B, generator=gen, device=dev) < self.cfg["push_prob"]
        theta = 2.0 * math.pi * torch.rand(B, generator=gen, device=dev)
        resample = torch.rand(B, generator=gen, device=dev) < self.cfg["command_resample_prob"]
        command = 2.0 * torch.rand((B, 3), generator=gen, device=dev) - 1.0
        action = torch.clamp(action, -1.0, 1.0)
        target = self.default_pose + self.action_scale * action
        magnitude = pushing.to(torch.float32) * self.cfg["push_force"]
        push = (magnitude * torch.cos(theta), magnitude * torch.sin(theta), magnitude * 0.0)
        qpos, qvel, normals = (physics or self.control_step)(s, target, push)
        n = {
            "qpos": qpos, "qvel": qvel,
            "cmd": torch.where(resample[:, None], self.max_command * command, s["cmd"]),
            "prev_action": action,
        }
        for name in self.dr_fields:
            n["dr." + name] = s["dr." + name]
        n = self._derived(n, action, s["prev_action"], normals[:, :4])
        n["step_counter"] = s["step_counter"] + 1
        n["truncated"] = n["step_counter"] >= self.cfg["episode_length"]
        n["done"] = (n.pop("fallen") | n["truncated"]).to(torch.float32)
        return n

    def obs(self, s: dict) -> dict:
        return {"command": s["obs.command"], "proprio": s["obs.proprio"]}

    def rewards(self, s: dict) -> dict:
        return {"penalty": s["reward.penalty"], "tracking": s["reward.tracking"]}
