"""Runtime types for PPO. Port of ``nnx_ppo_tpu/algorithms/types.py``
(``TrainingState`` :48, ``Transition`` :68, ``LoggingLevel`` :120)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch

from nnx_ppo_tpu_torch.networks.types import PPONetworkOutput


@dataclasses.dataclass
class TrainingState:
    """Everything a training run carries from one step to the next.

    Unlike the JAX pytree, ``networks`` and ``opt_state`` (the
    ``torch.optim.Optimizer`` over ``networks.parameters()``) are updated
    in place by ``ppo_step``. ``generator`` is the one device
    ``torch.Generator`` that every draw of the run comes from (it takes
    the place of the JAX ``rng_key``); ``steps_taken`` is counted on the
    host.
    """

    networks: Any  # StatefulModule on the run's device
    network_states: Any  # per-env carries, leading dim n_envs
    env_states: Any  # batched env State, leading dim n_envs
    opt_state: torch.optim.Optimizer
    generator: torch.Generator
    steps_taken: int

    def replace(self, **changes: Any) -> "TrainingState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Transition:
    """One (or a stacked ``[T]`` of) environment transition(s).

    ``rewards`` / ``done`` / ``truncated`` are ``[B]`` for one step and
    ``[T, B]`` for a rollout; ``done`` and ``truncated`` are bool.
    """

    obs: Any
    network_output: PPONetworkOutput
    rewards: Any
    done: torch.Tensor
    truncated: torch.Tensor
    next_obs: Any
    metrics: dict[str, Any]
    rollout_extras: Any = None


class LoggingLevel(enum.Flag):
    LOSSES = enum.auto()
    CRITIC_EXTRA = enum.auto()
    ACTOR_EXTRA = enum.auto()
    TRAIN_ROLLOUT_STATS = enum.auto()
    ROLLOUT_OBS = enum.auto()
    TRAINING_ENV_METRICS = enum.auto()
    GRAD_NORM = enum.auto()
    WEIGHTS = enum.auto()
    THROUGHPUT = enum.auto()
    BASIC = LOSSES
    ALL = (
        LOSSES
        | ACTOR_EXTRA
        | CRITIC_EXTRA
        | TRAIN_ROLLOUT_STATS
        | TRAINING_ENV_METRICS
        | GRAD_NORM
        | WEIGHTS
        | ROLLOUT_OBS
        | THROUGHPUT
    )
    NONE = 0
