"""Time-limit truncation wrapper, batched.

Port of ``nnx_ppo_tpu/wrappers/episode_wrapper.py``. Keeps
``info["step_counter"]`` (int32) and sets ``info["truncated"]`` (bool)
at ``max_len``; truncation forces ``done`` (float32). Initial step
counters are staggered, drawn in ``[0, max_len // 2)``, so episodes
across the batch do not truncate in lockstep. ``step`` forwards the
caller's generator to the wrapped env (envs that draw in ``step`` need
it; the others ignore it).
"""

from __future__ import annotations

from typing import Any

import torch

from nnx_ppo_tpu_torch.envs.types import State


class EpisodeWrapper:
    def __init__(self, env: Any, max_len: int):
        self.env = env
        self.max_len = max_len

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        next_state = self.env.step(state, action, generator)
        step_counter = state.info["step_counter"] + 1
        truncated = step_counter >= self.max_len
        if "truncated" in next_state.info:
            truncated = truncated | next_state.info["truncated"]
        info = dict(next_state.info)
        info["step_counter"] = step_counter
        info["truncated"] = truncated
        done = (next_state.done != 0) | truncated
        return next_state.replace(info=info, done=done.to(torch.float32))

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        next_state = self.env.reset(batch_size, generator)
        info = dict(next_state.info)
        info["step_counter"] = torch.randint(
            0,
            self.max_len // 2,
            (batch_size,),
            generator=generator,
            device=generator.device,
            dtype=torch.int32,
        )
        info["truncated"] = torch.zeros(
            batch_size, dtype=torch.bool, device=generator.device
        )
        return next_state.replace(info=info)

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size
