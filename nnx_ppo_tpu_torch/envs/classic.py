"""Analytic control envs, batched over envs: the cart-pole tasks and the
pendulum.

Port of ``nnx_ppo_tpu/envs/classic.py`` (``_Cartpole`` :33,
``CartpoleBalance`` :127, ``CartpoleSwingup`` :143, ``Pendulum`` :153).
The JAX envs step one env and are vmapped; these step a ``[B, k]`` state
at once with the same update. The cart-pole state is ``q = (x, theta,
x_dot, theta_dot)``, semi-implicit Euler, 5-D observation ``[x, cos
theta, sin theta, x_dot, theta_dot]``, smooth reward in [0, 1],
termination at ``|x| > 2.4`` (and, for the balance task, ``|theta| >
angle_limit = 0.8``). The pendulum's state is ``q = (theta,
theta_dot)``, 3-D observation ``[cos theta, sin theta, theta_dot]``, no
termination. ``done`` is float32. The cart-pole tasks ``render`` a
trajectory on the host with numpy (JAX ``classic.py:97-130``). Each env draws only in ``reset``:
``_draw_reset`` draws and ``_reset_from`` builds the state, so that a
test can inject another package's draws; ``step`` ignores its generator.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.envs.types import State


def _tolerance(x: torch.Tensor, bound: float, margin: float) -> torch.Tensor:
    """dm_control-style smooth tolerance: 1 inside ``|x| <= bound``,
    gaussian falloff with scale ``margin`` outside."""
    d = torch.clamp(torch.abs(x) - bound, min=0.0)
    return torch.exp(-0.5 * (d / margin) ** 2)


class _Cartpole:
    """Shared cart-pole dynamics (classic Barto-Sutton equations,
    semi-implicit Euler)."""

    gravity: float = 9.8
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_half_length: float = 0.5
    force_mag: float = 10.0
    dt: float = 0.02
    x_limit: float = 2.4
    # Episode ends when |theta| exceeds this (None = no angle limit).
    angle_limit: Optional[float] = None

    observation_size: int = 5
    action_size: int = 1

    def _physics(self, q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x, theta, x_dot, theta_dot = q.unbind(-1)
        force = self.force_mag * torch.clamp(action, -1.0, 1.0).reshape(q.shape[0])
        total_mass = self.cart_mass + self.pole_mass
        ml = self.pole_mass * self.pole_half_length
        cos_t = torch.cos(theta)
        sin_t = torch.sin(theta)
        temp = (force + ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_half_length
            * (4.0 / 3.0 - self.pole_mass * cos_t**2 / total_mass)
        )
        x_acc = temp - ml * theta_acc * cos_t / total_mass
        x_dot = x_dot + self.dt * x_acc
        theta_dot = theta_dot + self.dt * theta_acc
        x = x + self.dt * x_dot
        theta = theta + self.dt * theta_dot
        return torch.stack([x, theta, x_dot, theta_dot], dim=-1)

    def _state(self, q: torch.Tensor) -> State:
        x, theta, x_dot, theta_dot = q.unbind(-1)
        cos_t = torch.cos(theta)
        obs = torch.stack([x, cos_t, torch.sin(theta), x_dot, theta_dot], dim=-1)
        upright = (cos_t + 1.0) / 2.0
        centered = _tolerance(x, bound=0.25, margin=1.0)
        small_velocity = _tolerance(theta_dot, bound=0.5, margin=2.0)
        reward = upright * (1.0 + centered) / 2.0 * (1.0 + small_velocity) / 2.0
        done = torch.abs(x) > self.x_limit
        if self.angle_limit is not None:
            done = done | (torch.abs(theta) > self.angle_limit)
        return State(
            data={"q": q},
            obs=obs,
            reward=reward,
            done=done.to(torch.float32),
            info={},
            metrics={"reward": reward},
        )

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """Unit-normal state noise ``[B, 4]``."""
        return torch.randn((batch_size, 4), generator=generator, device=generator.device)

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The cart-pole draws nothing in step; the generator is ignored.
        del generator
        return self._state(self._physics(state.data["q"], action))

    def render(self, trajectory, height: int = 240, width: int = 320) -> list:
        """Rasterize a trajectory of (Slim)States, one env each, into HWC
        uint8 frames: the track, the cart and the pole, sampled along its
        length."""
        frames = []
        scale = width / (2 * self.x_limit + 1.0)
        pole_len = 2 * self.pole_half_length * scale
        cart_y = int(height * 0.7)
        for slim in trajectory:
            q = np.asarray(slim.data["q"])
            x, theta = float(q[0]), float(q[1])
            frame = np.full((height, width, 3), 255, np.uint8)
            frame[cart_y + 3, :, :] = 120  # track
            cx = int(width / 2 + x * scale)
            frame[
                max(cart_y - 8, 0) : cart_y + 3,
                max(cx - 14, 0) : min(cx + 14, width),
                :,
            ] = (40, 40, 200)
            # Pole: sample points along its length.
            tip_dx, tip_dy = np.sin(theta) * pole_len, np.cos(theta) * pole_len
            for t in np.linspace(0.0, 1.0, int(pole_len) * 2):
                px = int(cx + t * tip_dx)
                py = int(cart_y - 8 - t * tip_dy)
                if 0 <= px < width - 1 and 0 <= py < height - 1:
                    frame[py : py + 2, px : px + 2, :] = (200, 60, 40)
            frames.append(frame)
        return frames


class CartpoleBalance(_Cartpole):
    """Start near upright; keep the pole balanced and the cart centered.
    The episode terminates when the pole falls past ``angle_limit``."""

    angle_limit: Optional[float] = 0.8

    def _reset_from(self, noise: torch.Tensor) -> State:
        return self._state(0.05 * noise)


class CartpoleSwingup(_Cartpole):
    """Start hanging down; swing up and balance."""

    def _reset_from(self, noise: torch.Tensor) -> State:
        q = 0.05 * noise
        return self._state(torch.cat([q[:, :1], q[:, 1:2] + math.pi, q[:, 2:]], dim=-1))


class Pendulum:
    """Classic torque-limited pendulum swing-up. 3-D obs
    ``[cos θ, sin θ, θ̇]``, 1-D action, reward in [0, 1]."""

    gravity: float = 10.0
    mass: float = 1.0
    length: float = 1.0
    dt: float = 0.05
    max_torque: float = 2.0
    max_speed: float = 8.0

    observation_size: int = 3
    action_size: int = 1

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """``q[B, 2]``: theta uniform in [-π, π), theta_dot in [-1, 1)."""
        u = torch.rand((batch_size, 2), generator=generator, device=generator.device)
        low = torch.tensor([-math.pi, -1.0], device=generator.device)
        return low + u * (-2.0 * low)

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, q: torch.Tensor) -> State:
        return self._state(q)

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The pendulum draws nothing in step; the generator is ignored.
        del generator
        theta, theta_dot = state.data["q"].unbind(-1)
        torque = self.max_torque * torch.clamp(action, -1.0, 1.0).reshape(theta.shape[0])
        theta_acc = (
            3.0 * self.gravity / (2.0 * self.length) * torch.sin(theta)
            + 3.0 / (self.mass * self.length**2) * torque
        )
        theta_dot = torch.clamp(theta_dot + self.dt * theta_acc, -self.max_speed, self.max_speed)
        theta = theta + self.dt * theta_dot
        return self._state(torch.stack([theta, theta_dot], dim=-1))

    def _state(self, q: torch.Tensor) -> State:
        theta, theta_dot = q.unbind(-1)
        cos_t = torch.cos(theta)
        upright = (cos_t + 1.0) / 2.0
        still = torch.exp(-0.1 * theta_dot**2)
        reward = upright * (0.8 + 0.2 * still)
        return State(
            data={"q": q},
            obs=torch.stack([cos_t, torch.sin(theta), theta_dot], dim=-1),
            reward=reward,
            done=torch.zeros_like(theta),
            info={},
            metrics={"reward": reward},
        )
