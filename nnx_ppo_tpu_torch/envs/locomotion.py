"""Analytic joystick-command locomotion, batched over envs.

Port of ``nnx_ppo_tpu/envs/locomotion.py``: a planar rigid body tracks a
randomly resampled velocity command with **dict observations** (a
proprioceptive stream and a command stream) and a **dict reward** (one
GAE per key downstream). The dynamics are a fixed linear "gait map" from
8 joint-like actuators to body-frame thrust / lateral force / yaw torque,
plus first-order actuator lag; no physics kernel runs.

The JAX env steps one env and is vmapped, and carries a key per env in
its state; this one steps ``[B, ...]`` tensors and draws from the
caller's ``torch.Generator`` behind ``_draw_reset`` / ``_draw_step``, so
that a test can inject another package's draws into ``_reset_from`` /
``_step_from``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.core.device import DeviceConstants
from nnx_ppo_tpu_torch.envs.types import State

# The JAX env's fixed full-rank gait map, 8 actuators -> (thrust,
# lateral, yaw): ``jax.random.normal(jax.random.key(7), (3, 8)) /
# jnp.sqrt(8)`` in float32, copied here (not trained, not per env).
GAIT_MAP = np.array(
    [
        [0.1595357209444046, 0.6906492114067078, -0.18251821398735046, -0.04982991889119148,
         0.2176109403371811, 0.11819873005151749, -0.04572317749261856, -0.07910279929637909],
        [-0.5223930478096008, -0.4746122658252716, -0.11621060967445374, 0.35341665148735046,
         0.18672651052474976, -0.617424726486206, 0.5211348533630371, -0.013334134593605995],
        [-0.09006916731595993, 0.2587120532989502, -0.12113338708877563, 0.6898258924484253,
         0.5356165170669556, -0.09239222854375839, -0.135959193110466, 0.16466262936592102],
    ],
    dtype=np.float32,
)


class JoystickLocomotion(DeviceConstants):
    """Velocity-command tracking with dict obs / dict rewards.

    Observation (dict of ``[B, ...]``)::

        {"proprio": [14]  (body-frame vel (3) ‖ actuator states (8) ‖
                           cos(heading), sin(heading), height
                           oscillator (3)),
         "command": [3]   (vx*, vy*, ω*)}

    Action: ``[B, 8]`` in [-1, 1] (joint-like actuators).
    Reward: ``{"tracking": r_lin · r_ang, "penalty": -c₁‖Δa‖² - c₂‖a‖²}``.
    """

    n_actuators: int = 8
    dt: float = 0.02
    actuator_tau: float = 0.1  # first-order actuator lag
    drag: float = 1.2
    max_speed: float = 2.0
    max_yaw_rate: float = 2.0
    tracking_sigma: float = 0.25
    action_rate_cost: float = 0.01
    energy_cost: float = 0.002

    observation_size = {"proprio": 14, "command": 3}
    action_size: int = 8

    def __init__(self, command_resample_prob: float = 0.004):
        self._gait_map = torch.from_numpy(GAIT_MAP.copy())
        self.command_resample_prob = command_resample_prob

    # -- draws ---------------------------------------------------------------

    def _sample_command(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """``[B, 3]``: vx uniform in [-1, max_speed), vy in [-0.8, 0.8), ωz
        in [-max_yaw_rate, max_yaw_rate)."""
        u = torch.rand((batch_size, 3), generator=generator, device=generator.device)
        low = torch.tensor([-1.0, -0.8, -self.max_yaw_rate], device=generator.device)
        high = torch.tensor([self.max_speed, 0.8, self.max_yaw_rate], device=generator.device)
        return low + u * (high - low)

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """``command[B, 3]`` and ``vel_noise[B, 3]`` (unit normal)."""
        dev = generator.device
        return {
            "command": self._sample_command(batch_size, generator),
            "vel_noise": torch.randn((batch_size, 3), generator=generator, device=dev),
        }

    def _draw_step(self, batch_size: int, generator: torch.Generator):
        """``(resample[B] bool, command[B, 3])`` of one step."""
        dev = generator.device
        resample = (
            torch.rand(batch_size, generator=generator, device=dev) < self.command_resample_prob
        )
        return resample, self._sample_command(batch_size, generator)

    # -- state ---------------------------------------------------------------

    def _obs(self, q: dict) -> dict:
        theta = q["theta"]
        proprio = torch.cat(
            [
                q["vel"],  # body-frame [vx, vy, wz]
                q["act"],  # 8 actuator states
                torch.stack([torch.cos(theta), torch.sin(theta), q["height_osc"]], dim=-1),
            ],
            dim=-1,
        )
        return {"proprio": proprio, "command": q["cmd"]}

    def _reward(self, q: dict, action: torch.Tensor, prev_action: torch.Tensor) -> dict:
        vel, cmd = q["vel"], q["cmd"]
        lin_err = torch.sum((vel[:, :2] - cmd[:, :2]) ** 2, dim=-1)
        ang_err = (vel[:, 2] - cmd[:, 2]) ** 2
        tracking = torch.exp(-lin_err / self.tracking_sigma) * torch.exp(
            -ang_err / self.tracking_sigma
        )
        penalty = -(
            self.action_rate_cost * torch.sum((action - prev_action) ** 2, dim=-1)
            + self.energy_cost * torch.sum(action**2, dim=-1)
        )
        return {"tracking": tracking, "penalty": penalty}

    def _state(self, q: dict, reward: dict, done: torch.Tensor) -> State:
        return State(
            data=q,
            obs=self._obs(q),
            reward=reward,
            done=done,
            info={},
            metrics={
                "tracking_reward": reward["tracking"],
                "speed": torch.linalg.norm(q["vel"][:, :2], dim=-1),
            },
        )

    # -- protocol ------------------------------------------------------------

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        cmd = draws["command"]
        B, dev = cmd.shape[0], cmd.device
        zero = torch.zeros(B, device=dev)
        q = {
            "vel": 0.1 * draws["vel_noise"],
            "act": torch.zeros((B, self.n_actuators), device=dev),
            "prev_action": torch.zeros((B, self.n_actuators), device=dev),
            "theta": zero,
            "height_osc": zero,
            "cmd": cmd,
            "t": zero,
        }
        return self._state(q, {"tracking": zero, "penalty": zero}, zero)

    def step(
        self, state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> State:
        if generator is None:
            raise ValueError(
                "JoystickLocomotion.step draws (command resampling): pass the run's generator"
            )
        return self._step_from(state, action, self._draw_step(action.shape[0], generator))

    def _step_from(self, state: State, action: torch.Tensor, resample) -> State:
        q = state.data
        action = torch.clamp(action.reshape(-1, self.n_actuators), -1.0, 1.0)

        # First-order actuator lag, then the gait map to a body wrench.
        alpha = self.dt / self.actuator_tau
        act = q["act"] + alpha * (action - q["act"])
        wrench = act @ self._on(act.device, "_gait_map").T  # [thrust, lateral, yaw]

        vel = q["vel"] + self.dt * (3.0 * wrench - self.drag * q["vel"])
        vel = torch.clamp(vel, -2.0 * self.max_speed, 2.0 * self.max_speed)
        theta = q["theta"] + self.dt * vel[:, 2]
        height_osc = torch.sin(8.0 * math.pi * q["t"])  # gait-phase proxy

        # Occasionally resample the command mid-episode.
        resample_now, command = resample
        cmd = torch.where(resample_now[:, None], command, q["cmd"])

        new_q = {
            "vel": vel,
            "act": act,
            "prev_action": action,
            "theta": theta,
            "height_osc": height_osc,
            "cmd": cmd,
            "t": q["t"] + self.dt,
        }
        reward = self._reward(new_q, action, q["prev_action"])
        # Fall proxy: terminate on extreme body velocity.
        done = (torch.linalg.norm(vel, dim=-1) > 3.0 * self.max_speed).to(torch.float32)
        return self._state(new_q, reward, done)
