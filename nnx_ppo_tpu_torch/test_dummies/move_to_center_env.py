"""2-D analytic point env rewarded near the origin, batched. Port of
``nnx_ppo_tpu/test_dummies/move_to_center_env.py``; the end-to-end
convergence gate."""

from __future__ import annotations

import math

import torch

from nnx_ppo_tpu_torch.envs.types import State


def draw_polar_start(batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """``[B, 2]`` uniform in [0, 1): the start's angle (in turns) and its
    radius (as a fraction of 0.9 border radii)."""
    return torch.rand((batch_size, 2), generator=generator, device=generator.device)


def polar_start(draws: torch.Tensor, border_radius: float) -> torch.Tensor:
    """Start positions ``[B, 2]`` from :func:`draw_polar_start`'s draws."""
    phi, rad = draws.unbind(-1)
    rad = rad * (border_radius * 0.9)
    return torch.stack(
        [torch.cos(2 * math.pi * phi) * rad, torch.sin(2 * math.pi * phi) * rad], dim=-1
    )


class MoveToCenterEnv:
    """Continuous 2-D steps; reward peaks at the origin; the episode ends
    if the agent strays past ``border_radius``."""

    def __init__(self, reward_falloff: float = 0.5, border_radius: float = 2.0):
        self.reward_falloff = reward_falloff
        self.border_radius = border_radius

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(draw_polar_start(batch_size, generator))

    def _reset_from(self, draws: torch.Tensor) -> State:
        return self._get_state({"pos": polar_start(draws, self.border_radius)})

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The point env draws nothing in step; the generator is ignored.
        del generator
        action = torch.clamp(action, -1, 1)
        return self._get_state({"pos": state.data["pos"] + action})

    def _get_state(self, data: dict) -> State:
        d_sqr = torch.square(data["pos"]).sum(dim=-1)
        reward = torch.exp(-(d_sqr / (self.reward_falloff**2) / 2))
        return State(
            data=data,
            obs=data["pos"] / 10.0,
            info={},
            reward=reward,
            done=torch.where(d_sqr > self.border_radius**2, 1.0, 0.0),
            metrics={},
        )

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 2
