"""Configuration dataclasses. A copy of ``nnx_ppo_tpu/algorithms/config.py``
(``PPOConfig``, ``EvalConfig``, ``VideoConfig``, ``TrainConfig``,
``TrainResult``, ``DistillationConfig``, ``DistillationTrainConfig``,
``DistillationTrainResult``, :142-211; ``VideoData``, :183-190) with the
same fields and defaults.

The replay options are JAX's: ``fused_replay``; ``rollout_layout``
"auto" (batch-major for a fully replay-time-static network under
``fused_replay``, else time-major), "time_major" or "batch_major"
(``algorithms/ppo.py::resolve_batch_major``); ``replay_store_dtype``
"float32" or "bfloat16" (``resolve_store_dtype``: the float observation
leaves of the replay view stored in bf16, exact only for a bf16-compute
network without obs normalization; any other network replays
bf16-rounded observations); and shuffled or contiguous minibatches
(``shuffle_minibatches``). For a replay-time-static network the
batch-major layout gives the time-major losses up to float32 reduction
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from nnx_ppo_tpu_torch.algorithms.types import DistillationState, LoggingLevel, TrainingState


@dataclass(frozen=True)
class PPOConfig:
    """Core PPO algorithm parameters."""

    n_envs: int = 256
    rollout_length: int = 20
    total_steps: int = 512_000
    gae_lambda: float = 0.95
    discounting_factor: float = 0.99
    clip_range: float = 0.2
    learning_rate: float = 1e-4
    normalize_advantages: bool = True
    combine_advantages: bool = False
    n_epochs: int = 4
    n_minibatches: int = 4
    critic_loss_weight: float = 1.0
    # Linearly decay the learning rate to 0 over the run (one schedule
    # step per minibatch update). Ignored when a custom optimizer is given.
    anneal_lr: bool = False
    gradient_clipping: Optional[float] = None
    weight_decay: Optional[float] = None
    logging_level: LoggingLevel = LoggingLevel.LOSSES
    logging_percentiles: Optional[tuple[int, ...]] = None
    fused_replay: bool = True
    rollout_layout: str = "auto"
    replay_store_dtype: str = "float32"
    shuffle_minibatches: bool = True
    # PPO iterations per train_ppo call of ppo_multi_step.
    steps_per_call: int = 1


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation rollout configuration."""

    enabled: bool = True
    every_steps: int = 50_000
    n_envs: int = 64
    max_episode_length: int = 1000
    logging_level: LoggingLevel = LoggingLevel.BASIC
    logging_percentiles: Optional[tuple[int, ...]] = (0, 25, 50, 75, 100)


@dataclass(frozen=True)
class VideoConfig:
    """Video recording configuration."""

    enabled: bool = False
    every_steps: int = 200_000
    episode_length: int = 1000
    render_kwargs: tuple[tuple[str, Any], ...] = (("height", 480), ("width", 640))

    @property
    def render_kwargs_dict(self) -> dict[str, Any]:
        return dict(self.render_kwargs)


@dataclass(frozen=True)
class TrainConfig:
    """Complete training configuration."""

    ppo: PPOConfig = field(default_factory=PPOConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    seed: int = 17
    checkpoint_every_steps: int = 500_000


@dataclass
class VideoData:
    """Data passed to the video callback."""

    frames: np.ndarray  # (T, H, W, C), uint8
    step: int
    episode_reward: float
    episode_length: int


@dataclass
class TrainResult:
    """Result of train_ppo: final state, metrics, eval history."""

    training_state: TrainingState
    final_metrics: dict[str, Any]
    eval_history: list[dict[str, Any]]
    total_steps: int
    total_iterations: int


@dataclass(frozen=True)
class DistillationConfig:
    """Core distillation algorithm parameters (the replay options as
    ``PPOConfig``'s; the teacher's extras always stay exact, so the NLL
    target is unchanged by ``replay_store_dtype``)."""

    n_envs: int = 256
    rollout_length: int = 20
    total_steps: int = 512_000
    learning_rate: float = 1e-4
    n_epochs: int = 4
    n_minibatches: int = 4
    gradient_clipping: Optional[float] = None
    weight_decay: Optional[float] = None
    logging_level: LoggingLevel = LoggingLevel.LOSSES
    logging_percentiles: Optional[tuple[int, ...]] = None
    fused_replay: bool = True
    rollout_layout: str = "auto"
    replay_store_dtype: str = "float32"
    shuffle_minibatches: bool = True


@dataclass(frozen=True)
class DistillationTrainConfig:
    """Complete training configuration for distillation."""

    distillation: DistillationConfig = field(default_factory=DistillationConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    seed: int = 17
    checkpoint_every_steps: int = 500_000


@dataclass
class DistillationTrainResult:
    """Result of train_distillation."""

    training_state: DistillationState
    final_metrics: dict[str, Any]
    eval_history: list[dict[str, Any]]
    total_steps: int
    total_iterations: int
