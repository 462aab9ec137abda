"""PPOAdapter: two-port router from network output to ``PPONetworkOutput``.

Port of ``nnx_ppo_tpu/networks/adapter.py:41-136``. The action port must
output a sampler dict ``{"action", "log_likelihood"}`` (or a tree of
them); the value port's output is used directly with a trailing
singleton axis squeezed (``[B, 1]`` -> ``[B]``).
"""

from __future__ import annotations

from typing import Any

import torch

from nnx_ppo_tpu_torch.networks.types import (
    ModuleOutput,
    ModuleState,
    PPONetworkOutput,
    StatefulModule,
)

_SAMPLER_DICT_KEYS = frozenset({"action", "log_likelihood"})


def is_sampler_dict(x: Any) -> bool:
    return isinstance(x, dict) and _SAMPLER_DICT_KEYS.issubset(x.keys())


def _pick(tree: Any, key: str) -> Any:
    """``tree.map(lambda d: d[key], tree, is_leaf=is_sampler_dict)``."""
    if is_sampler_dict(tree):
        return tree[key]
    return {k: _pick(v, key) for k, v in tree.items()}


def _squeeze_trailing_one(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _squeeze_trailing_one(x) for k, x in v.items()}
    if torch.is_tensor(v) and v.ndim and v.shape[-1] == 1:
        return v.squeeze(-1)
    return v


def _ppo_output(action_out: Any, value_out: Any) -> PPONetworkOutput:
    return PPONetworkOutput(
        actions=_pick(action_out, "action"),
        loglikelihoods=_pick(action_out, "log_likelihood"),
        value_estimates=_squeeze_trailing_one(value_out),
    )


class PPOAdapter(StatefulModule):
    """Runs the ``action`` and ``value`` ports on the same input."""

    def __init__(self, action: StatefulModule, value: StatefulModule):
        super().__init__()
        self.action = action
        self.value = value

    @classmethod
    def create(cls, action: StatefulModule, value: StatefulModule) -> "PPOAdapter":
        return cls(action, value)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        a_re = None if rollout_extras is None else rollout_extras["action"]
        v_re = None if rollout_extras is None else rollout_extras["value"]
        a_out = self.action(state["action"], x, a_re, generator)
        v_out = self.value(state["value"], x, v_re, generator)
        return ModuleOutput(
            next_state={"action": a_out.next_state, "value": v_out.next_state},
            output=_ppo_output(a_out.output, v_out.output),
            regularization_loss=a_out.regularization_loss + v_out.regularization_loss,
            metrics={"action": a_out.metrics, "value": v_out.metrics},
            rollout_extras={"action": a_out.rollout_extras, "value": v_out.rollout_extras},
        )

    def initialize_state(self, batch_size: int) -> ModuleState:
        return {
            "action": self.action.initialize_state(batch_size),
            "value": self.value.initialize_state(batch_size),
        }

    def reset_state(self, prev_state) -> ModuleState:
        return {
            "action": self.action.reset_state(prev_state["action"]),
            "value": self.value.reset_state(prev_state["value"]),
        }

    def update_statistics(self, rollout_extras) -> "PPOAdapter":
        self.action.update_statistics(rollout_extras["action"])
        self.value.update_statistics(rollout_extras["value"])
        return self

    @property
    def replay_time_static(self) -> bool:
        return self.action.replay_time_static and self.value.replay_time_static

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        a_re = None if extras_seq is None else extras_seq["action"]
        v_re = None if extras_seq is None else extras_seq["value"]
        a_out, a_reg, a_final = self.action.replay_sequence(
            state["action"], obs_seq, done_seq, a_re
        )
        v_out, v_reg, v_final = self.value.replay_sequence(
            state["value"], obs_seq, done_seq, v_re
        )
        return (
            _ppo_output(a_out, v_out),
            a_reg + v_reg,
            {"action": a_final, "value": v_final},
        )
