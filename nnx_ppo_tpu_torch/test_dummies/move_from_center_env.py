"""2-D analytic point env penalized near the origin, batched. Port of
``nnx_ppo_tpu/test_dummies/move_from_center_env.py``: short lifespans are
preferred."""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.test_dummies.move_to_center_env import draw_polar_start, polar_start


class MoveFromCenterEnv:
    """Continuous 2-D steps; negative reward shrinking toward the border;
    the episode ends when the agent escapes past ``border_radius``."""

    def __init__(self, border_radius: float = 2.0):
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
        d = torch.linalg.norm(data["pos"], dim=-1)
        return State(
            data=data,
            obs=data["pos"],
            info={},
            reward=d / self.border_radius - 1.0,
            done=torch.where(d > self.border_radius, 1.0, 0.0),
            metrics={},
        )

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 2
