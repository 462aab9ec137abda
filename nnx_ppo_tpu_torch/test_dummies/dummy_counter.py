"""Counter env + net proving carry resets stay in lockstep with env
resets, batched.

Port of ``nnx_ppo_tpu/test_dummies/dummy_counter.py``. Reward is 1.0 iff
the action equals the number of steps since the last env reset;
``DummyCounterNet`` outputs its per-env carry counter, so the total
reward over a rollout equals T·B exactly iff net-carry resets are
synchronized with env resets."""

from __future__ import annotations

from typing import Any, Optional

import torch

from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, PPONetworkOutput, StatefulModule
from nnx_ppo_tpu_torch.core.struct import tree_map


class DummyCounterEnv:
    """Reward 1.0 iff action == steps-since-reset; obs is always [0.0];
    each episode ends after a length drawn in [3, 10)."""

    observation_size: int = 1
    action_size: int = 1

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """The episode lengths ``[B]``, int32, uniform in [3, 10)."""
        return torch.randint(
            3, 10, (batch_size,), generator=generator, device=generator.device,
            dtype=torch.int32,
        )

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, reset_step: torch.Tensor) -> State:
        B, dev = reset_step.shape[0], reset_step.device
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        return State(
            data={"current_step": zero, "reset_step": reset_step},
            obs=torch.zeros((B, 1), device=dev),
            reward=torch.ones(B, device=dev),
            done=torch.zeros(B, device=dev),
            info={"current_step": zero},
            metrics={},
        )

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The counter draws nothing in step; the generator is ignored.
        del generator
        current_step = state.data["current_step"] + 1
        data = {"current_step": current_step, "reset_step": state.data["reset_step"]}
        done = (current_step >= data["reset_step"]).to(torch.float32)
        hit = action.reshape(current_step.shape[0]) == current_step
        return State(
            data=data,
            obs=torch.zeros((current_step.shape[0], 1), device=current_step.device),
            info={"current_step": current_step},
            reward=hit.to(torch.float32),
            done=done,
            metrics=state.metrics,
        )


class DummyCounterNet(StatefulModule):
    """Outputs the number of steps since its carry was last reset."""

    def forward(
        self,
        state: Any,
        x: Any,
        rollout_extras: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> ModuleOutput:
        old_counter = state["counter_state"]["counter"]
        new_counter = old_counter + 1
        ones = torch.ones(old_counter.shape, device=old_counter.device)
        return ModuleOutput(
            next_state={"counter_state": {"counter": new_counter}},
            output=PPONetworkOutput(
                actions=new_counter.to(torch.float32)[:, None],
                loglikelihoods=ones,
                value_estimates=ones,
            ),
            regularization_loss=0.0,
            metrics={},
            rollout_extras=None,
        )

    def initialize_state(self, batch_size: int) -> dict:
        return {"counter_state": {"counter": torch.zeros(batch_size, dtype=torch.int32)}}

    def reset_state(self, prev_state: Any) -> Any:
        return tree_map(torch.zeros_like, prev_state)
