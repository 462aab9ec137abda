"""Cart-pole balance, batched over envs.

Port of ``nnx_ppo_tpu/envs/classic.py:33-140``. The JAX env steps one
env and is vmapped; this one steps a ``[B, 4]`` state ``q = (x, theta,
x_dot, theta_dot)`` at once, with the same semi-implicit Euler update,
5-D observation ``[x, cos theta, sin theta, x_dot, theta_dot]``, smooth
reward in [0, 1] and termination at ``|x| > 2.4`` or
``|theta| > angle_limit = 0.8``. ``done`` is float32.
"""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.envs.types import State


def _tolerance(x: torch.Tensor, bound: float, margin: float) -> torch.Tensor:
    """dm_control-style smooth tolerance: 1 inside ``|x| <= bound``,
    gaussian falloff with scale ``margin`` outside."""
    d = torch.clamp(torch.abs(x) - bound, min=0.0)
    return torch.exp(-0.5 * (d / margin) ** 2)


class CartpoleBalance:
    """Start near upright; keep the pole balanced and the cart centered."""

    gravity: float = 9.8
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_half_length: float = 0.5
    force_mag: float = 10.0
    dt: float = 0.02
    x_limit: float = 2.4
    angle_limit: float = 0.8

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
        done = (torch.abs(x) > self.x_limit) | (torch.abs(theta) > self.angle_limit)
        return State(
            data={"q": q},
            obs=obs,
            reward=reward,
            done=done.to(torch.float32),
            info={},
            metrics={"reward": reward},
        )

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        q = 0.05 * torch.randn(
            (batch_size, 4), generator=generator, device=generator.device
        )
        return self._state(q)

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The cart-pole draws nothing in step; the generator is ignored.
        del generator
        return self._state(self._physics(state.data["q"], action))
