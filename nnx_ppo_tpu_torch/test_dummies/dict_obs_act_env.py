"""Dict-obs / dict-action / multi-agent test dummies, batched. Port of
``nnx_ppo_tpu/test_dummies/dict_obs_act_env.py``: they check that the PPO
pipeline carries dict observations, actions, rewards and multi-head
values.

Both nets declare themselves replay-time-static: their carry is empty,
so a replay's output depends only on (params, input, stored extras). The
JAX nets keep the default (False) and replay by a scan over time, which
gives the same result for an empty carry; the port replays every
minibatch as one forward over its ``[T, B]`` leading dims (one forward
where the scan would run T), so their zero log-likelihoods and
regularization take the obs's batch dims instead of one batch size.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, PPONetworkOutput, StatefulModule


def _uniform_pm1(batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """``[B, 2]`` uniform in [-1, 1)."""
    u = torch.rand((batch_size, 2), generator=generator, device=generator.device)
    return 2.0 * u - 1.0


def lecun_normal(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal`` for an ``[in, out]`` kernel: a
    normal truncated at two standard deviations, of std
    ``sqrt(1 / in) / 0.8796...`` (the truncated normal's own std)."""
    std = (1.0 / shape[0]) ** 0.5 / 0.87962566103423978
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return out


class DictObsActEnv:
    """2-D env with dict obs ``{"pos", "vel"}`` and dict action
    ``{"force"}``; vel += 0.1·force, pos += vel; reward exp(−|pos|);
    done (float) at |pos| > 3."""

    observation_size = {"pos": 2, "vel": 2}
    action_size = {"force": 2}

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(_uniform_pm1(batch_size, generator))

    def _reset_from(self, pos: torch.Tensor) -> State:
        return self._make_state(pos, torch.zeros_like(pos))

    def step(self, state: State, action: dict, generator=None) -> State:
        # Nothing is drawn in step; the generator is ignored.
        del generator
        new_vel = state.obs["vel"] + action["force"] * 0.1
        new_pos = state.obs["pos"] + new_vel
        return self._make_state(new_pos, new_vel)

    def _make_state(self, pos: torch.Tensor, vel: torch.Tensor) -> State:
        dist = torch.sqrt(torch.sum(pos**2, dim=-1))
        return State(
            data={},
            obs={"pos": pos, "vel": vel},
            reward=torch.exp(-dist),
            done=(dist > 3.0).to(torch.float32),
            info={},
            metrics={},
        )


class DictObsActNet(StatefulModule):
    """Minimal net: dict obs in, dict action out; log-likelihoods pinned
    at 0 (a pipeline test; critic gradients still flow). The pre-squash
    action is the rollout snapshot, replayed from ``rollout_extras``."""

    def __init__(self, actor_kernel: torch.Tensor, critic_kernel: torch.Tensor):
        super().__init__()
        self.actor_kernel = nn.Parameter(actor_kernel)
        self.critic_kernel = nn.Parameter(critic_kernel)

    @classmethod
    def create(cls, generator: torch.Generator) -> "DictObsActNet":
        return cls(lecun_normal((4, 2), generator), lecun_normal((4, 1), generator))

    @property
    def replay_time_static(self) -> bool:
        return True

    def forward(
        self,
        state: Any,
        x: Any,
        rollout_extras: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> ModuleOutput:
        obs_flat = torch.cat([x["pos"], x["vel"]], dim=-1)
        actor_out = obs_flat @ self.actor_kernel
        value = (obs_flat @ self.critic_kernel).squeeze(-1)
        raw_action = rollout_extras if rollout_extras is not None else {"force": actor_out}
        zeros = torch.zeros(obs_flat.shape[:-1], device=obs_flat.device)
        return ModuleOutput(
            next_state=state,
            output=PPONetworkOutput(
                actions={"force": torch.tanh(raw_action["force"])},
                loglikelihoods=zeros,
                value_estimates=value,
            ),
            regularization_loss=zeros,
            metrics={},
            rollout_extras=raw_action,
        )


class TwoArmEnv:
    """Minimal multi-agent env: per-arm obs dicts, per-arm actions,
    per-arm (dict) rewards with one shared done flag (bool)."""

    observation_size = {"arm1": {"pos": 2, "vel": 2}, "arm2": {"pos": 2, "vel": 2}}
    action_size = {"arm1": 2, "arm2": 2}

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """Each arm's start position ``[B, 2]``, uniform in [-1, 1)."""
        return {arm: _uniform_pm1(batch_size, generator) for arm in ("arm1", "arm2")}

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, pos: dict) -> State:
        return self._make_state(pos, {arm: torch.zeros_like(p) for arm, p in pos.items()})

    def step(self, state: State, action: dict, generator=None) -> State:
        # Nothing is drawn in step; the generator is ignored.
        del generator
        new_vel = {arm: state.obs[arm]["vel"] + 0.1 * action[arm] for arm in ("arm1", "arm2")}
        new_pos = {arm: state.obs[arm]["pos"] + 0.1 * new_vel[arm] for arm in ("arm1", "arm2")}
        return self._make_state(new_pos, new_vel)

    def _make_state(self, pos: dict, vel: dict) -> State:
        dist = {arm: torch.sqrt(torch.sum(p**2, dim=-1)) for arm, p in pos.items()}
        return State(
            data={},
            obs={arm: {"pos": pos[arm], "vel": vel[arm]} for arm in pos},
            reward={arm: torch.exp(-d) for arm, d in dist.items()},
            done=(dist["arm1"] > 3.0) | (dist["arm2"] > 3.0),
            info={},
            metrics={},
        )


class TwoArmNet(StatefulModule):
    """Dict obs/actions and dict (multi-head) value estimates."""

    def __init__(self, actor_kernel: torch.Tensor, critic_kernel: torch.Tensor):
        super().__init__()
        self.actor_kernel = nn.Parameter(actor_kernel)
        self.critic_kernel = nn.Parameter(critic_kernel)

    @classmethod
    def create(cls, generator: torch.Generator) -> "TwoArmNet":
        return cls(lecun_normal((8, 4), generator), lecun_normal((8, 2), generator))

    @property
    def replay_time_static(self) -> bool:
        return True

    def forward(
        self,
        state: Any,
        x: Any,
        rollout_extras: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> ModuleOutput:
        # The obs leaves in sorted-key order, as jax.flatten_util.ravel_pytree.
        obs_flat = torch.cat(
            [x[arm][k] for arm in sorted(x) for k in sorted(x[arm])], dim=-1
        )
        actor_out = obs_flat @ self.actor_kernel
        critic_out = obs_flat @ self.critic_kernel
        zeros = torch.zeros(obs_flat.shape[:-1], device=obs_flat.device)
        return ModuleOutput(
            next_state=state,
            output=PPONetworkOutput(
                actions={"arm1": actor_out[..., :2], "arm2": actor_out[..., 2:]},
                loglikelihoods={"arm1": zeros, "arm2": zeros},
                value_estimates={"arm1": critic_out[..., 0], "arm2": critic_out[..., 1]},
            ),
            regularization_loss=zeros,
            metrics={},
            rollout_extras=None,
        )
