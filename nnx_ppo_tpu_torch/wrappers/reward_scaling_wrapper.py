"""Constant reward scaling wrapper, batched.

Port of ``nnx_ppo_tpu/wrappers/reward_scaling_wrapper.py``. Multiplies
every reward leaf (a tensor, or each key of a dict reward) by
``reward_scale`` in ``reset`` and ``step``; ``step`` forwards the
caller's generator to the wrapped env. Any other attribute comes from
the wrapped env (``__getattr__``, as in the JAX wrapper).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from nnx_ppo_tpu_torch.algorithms.types import EnvState, RLEnv
from nnx_ppo_tpu_torch.core.struct import tree_map


class RewardScalingWrapper:
    def __init__(self, env: RLEnv, reward_scale: float) -> None:
        self.env = env
        self.reward_scale = reward_scale

    def _scaled(self, state: EnvState) -> EnvState:
        return state.replace(reward=tree_map(lambda r: self.reward_scale * r, state.reward))

    def reset(self, batch_size: int, generator: torch.Generator) -> EnvState:
        return self._scaled(self.env.reset(batch_size, generator))

    def step(
        self, state: EnvState, action: Any, generator: Optional[torch.Generator] = None
    ) -> EnvState:
        return self._scaled(self.env.step(state, action, generator))

    @property
    def observation_size(self) -> Any:
        return self.env.observation_size

    @property
    def action_size(self) -> Any:
        return self.env.action_size

    def __getattr__(self, name: str) -> Any:
        # Anything else (render, the env's own settings, ...) comes from
        # the wrapped env, so the wrapper stays transparent to its callers.
        if name == "env":
            # Reached only while 'env' is not yet in __dict__ (copy.deepcopy
            # or unpickling of a bare instance): raise instead of recursing.
            raise AttributeError(name)
        return getattr(self.env, name)
