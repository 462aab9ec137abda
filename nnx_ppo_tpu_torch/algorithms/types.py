"""Runtime types for PPO and distillation. Port of
``nnx_ppo_tpu/algorithms/types.py`` (``EnvState`` :16, ``RLEnv`` :37,
``TrainingState`` :48, ``Transition`` :68, ``DistillationTransition``
:88, ``DistillationState`` :106, ``LoggingLevel`` :120)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from nnx_ppo_tpu_torch.networks.types import PPONetworkOutput


@runtime_checkable
class EnvState(Protocol):
    """Minimal environment state interface, batched: every leaf has a
    leading env axis ``[B]``. Satisfied by
    :class:`nnx_ppo_tpu_torch.envs.types.State`."""

    @property
    def obs(self) -> Any: ...
    @property
    def done(self) -> torch.Tensor: ...  # bool or float depending on env
    @property
    def reward(self) -> Any: ...
    @property
    def info(self) -> dict[str, Any]: ...
    @property
    def metrics(self) -> dict[str, Any]: ...


@runtime_checkable
class RLEnv(Protocol):
    """A batched environment: ``reset`` makes ``batch_size`` envs at once
    and ``step`` steps them all.

    The JAX protocol is one unbatched env (``reset(rng)``, ``step(state,
    action)``) that the library vmaps; PyTorch has no vmap for Python
    control flow and runs eagerly, so here the env holds ``[B, ...]``
    tensors itself. JAX carries a PRNG key per env in the state; here
    every draw comes from the caller's ``torch.Generator`` (on the
    tensors' device), which ``step`` takes too: envs that draw in
    ``step`` (command resampling, pushes, sensor noise) need it, the
    others ignore it.
    """

    @property
    def observation_size(self) -> Any: ...
    @property
    def action_size(self) -> Any: ...

    def reset(self, batch_size: int, generator: torch.Generator) -> EnvState: ...
    def step(
        self, state: Any, action: Any, generator: Optional[torch.Generator] = None
    ) -> EnvState: ...


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


@dataclasses.dataclass
class DistillationTransition:
    """One (or a stacked ``[T]`` of) distillation transition(s). The
    student's actions drive the env; the teacher's ``rollout_extras``
    (its sampler holds the teacher's mean, since the teacher runs in eval
    mode) are the distillation target. ``done`` and ``truncated`` are
    bool."""

    obs: Any
    student_output: PPONetworkOutput  # drives the env; logging only
    rewards: Any
    done: torch.Tensor
    truncated: torch.Tensor
    next_obs: Any
    metrics: dict[str, Any]
    student_rollout_extras: Any = None
    teacher_rollout_extras: Any = None


@dataclasses.dataclass
class DistillationState:
    """Everything a distillation run carries from one step to the next.
    The teacher module is an argument of the step; only its per-env carry
    is kept here. As in :class:`TrainingState`, ``student`` and
    ``opt_state`` are updated in place, ``generator`` (one device
    ``torch.Generator``) takes the place of the JAX ``rng_key`` and
    ``steps_taken`` is counted on the host."""

    student: Any  # StatefulModule on the run's device
    student_states: Any
    teacher_states: Any
    env_states: Any
    opt_state: torch.optim.Optimizer
    generator: torch.Generator
    steps_taken: int

    def replace(self, **changes: Any) -> "DistillationState":
        return dataclasses.replace(self, **changes)


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
