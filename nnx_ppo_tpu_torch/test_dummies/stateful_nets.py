"""Stateful test networks. Port of
``nnx_ppo_tpu/test_dummies/stateful_nets.py``.

The call counter lives in the per-env carry, as in the JAX package:
summing the final carry gives the total number of (env, step) forward
evaluations."""

from __future__ import annotations

from typing import Any, Optional

import torch

from nnx_ppo_tpu_torch.networks.types import ModuleOutput, PPONetworkOutput, StatefulModule


class RepeatAndCountNet(StatefulModule):
    """Outputs its input as the action; counts calls in its carry.

    ``carry["n_calls"]`` is ``[B]`` int32, incremented once per forward.
    The counter is part of the carry, so it is zeroed by
    ``initialize_state`` and *survives* episode resets (``reset_state``
    keeps it): total calls = ``carry["n_calls"].sum()``.
    """

    def forward(
        self,
        state: Any,
        x: Any,
        rollout_extras: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> ModuleOutput:
        ones = torch.ones(x.shape[0], device=x.device)
        return ModuleOutput(
            next_state={"n_calls": state["n_calls"] + 1},
            output=PPONetworkOutput(actions=x, loglikelihoods=ones, value_estimates=ones),
            regularization_loss=0.0,
            metrics={},
            rollout_extras=None,
        )

    def initialize_state(self, batch_size: int) -> dict:
        return {"n_calls": torch.zeros(batch_size, dtype=torch.int32)}

    def reset_state(self, prev_state: Any) -> Any:
        return prev_state  # Counting survives episode resets.
