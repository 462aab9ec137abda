"""Scripted reset-schedule environment for rollout-machinery tests, batched.

Port of ``nnx_ppo_tpu/test_dummies/mock_env.py``: an action-agnostic env
whose only dynamics are a deterministic done schedule, so tests can
assert auto-reset bookkeeping exactly. The JAX env draws its observation
stream from a key carried in ``state.data``; this one draws it from the
caller's generator (``_draw_obs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nnx_ppo_tpu_torch.envs.types import State


class MockEnv:
    """Ignores actions; emits ``done`` (bool) every ``max_steps`` steps.

    Reward is a constant 1.0 per step (0.0 at reset), so
    ``rewards.sum() == T * B`` over any rollout: no transition is dropped
    or double-counted across auto-resets.
    """

    def __init__(self, obs_size: int, action_size: int, max_steps: int = 5):
        self.obs_size = obs_size
        self.action_size = action_size
        self.max_steps = max_steps
        self.observation_size = obs_size

    def _draw_obs(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """A fresh unit-normal observation ``[B, obs_size]``."""
        return torch.randn(
            (batch_size, self.obs_size), generator=generator, device=generator.device
        )

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_obs(batch_size, generator))

    def _reset_from(self, obs: torch.Tensor) -> State:
        B, dev = obs.shape[0], obs.device
        return State(
            data={"ticks": torch.zeros(B, dtype=torch.int32, device=dev)},
            obs=obs,
            reward=torch.zeros(B, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            info={},
            metrics={},
        )

    def step(
        self, state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> State:
        if generator is None:
            raise ValueError("MockEnv.step draws the next observation: pass the run's generator")
        return self._step_from(state, self._draw_obs(state.obs.shape[0], generator))

    def _step_from(self, state: State, obs: torch.Tensor) -> State:
        # The dynamics are purely schedule-driven: the action is ignored.
        ticks = state.data["ticks"] + 1
        return State(
            data={"ticks": ticks},
            obs=obs,
            reward=torch.ones(obs.shape[0], device=obs.device),
            done=ticks >= self.max_steps,
            info={},
            metrics={},
        )
