"""Obs-echo environment, batched: reward peaks when the action repeats
the previous observation.

Port of ``nnx_ppo_tpu/test_dummies/parrot_env.py``: a one-step-memory
target that a "repeat the obs" policy maximizes. The JAX env draws its
observation stream from a key carried in ``state.data``; this one draws
it from the caller's generator (``_draw_obs``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from nnx_ppo_tpu_torch.envs.types import State


class ParrotEnv:
    """Never-ending env; reward is a Gaussian bump in ‖action − prev_obs‖.

    A policy that outputs exactly the last observation earns reward 1
    every step (the tanh-squashed obs stream stays inside the action
    range, so perfect parroting is feasible).
    """

    def __init__(
        self, obs_size: Union[int, tuple[int, ...]] = (3,), reward_falloff: float = 0.5
    ):
        self.obs_size = obs_size if isinstance(obs_size, tuple) else (obs_size,)
        self.reward_falloff = reward_falloff

    def _draw_obs(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """Unit-normal noise ``[B, *obs_size]``; the obs is its tanh."""
        return torch.randn(
            (batch_size,) + self.obs_size, generator=generator, device=generator.device
        )

    def _echo_reward(self, action: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        err = torch.sum(torch.square(action - target).reshape(target.shape[0], -1), dim=-1)
        return torch.exp(-0.5 * err / self.reward_falloff**2)

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_obs(batch_size, generator))

    def _reset_from(self, noise: torch.Tensor) -> State:
        zero = torch.zeros(noise.shape[0], device=noise.device)
        # tanh squash keeps obs within the sampler's action range.
        return State(data={}, obs=torch.tanh(noise), reward=zero, done=zero, info={},
                     metrics={})

    def step(
        self, state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> State:
        if generator is None:
            raise ValueError("ParrotEnv.step draws the next observation: pass the run's generator")
        return self._step_from(state, action, self._draw_obs(state.obs.shape[0], generator))

    def _step_from(self, state: State, action: torch.Tensor, noise: torch.Tensor) -> State:
        return State(
            data={},
            obs=torch.tanh(noise),
            reward=self._echo_reward(action, state.obs),
            done=torch.zeros(noise.shape[0], device=noise.device),
            info={},
            metrics={},
        )

    @property
    def observation_size(self):
        return self.obs_size

    @property
    def action_size(self):
        return self.obs_size
