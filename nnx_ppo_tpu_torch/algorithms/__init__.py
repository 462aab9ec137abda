"""PPO training (port of ``nnx_ppo_tpu/algorithms``, flagship subset)."""

from nnx_ppo_tpu_torch.algorithms.config import (
    EvalConfig,
    PPOConfig,
    TrainConfig,
    TrainResult,
    VideoConfig,
)
from nnx_ppo_tpu_torch.algorithms.ppo import (
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_multi_step,
    ppo_step,
    ppo_update,
    train_ppo,
)
from nnx_ppo_tpu_torch.algorithms.types import (
    EnvState,
    LoggingLevel,
    RLEnv,
    TrainingState,
    Transition,
)

__all__ = [
    "EnvState",
    "EvalConfig",
    "LoggingLevel",
    "PPOConfig",
    "RLEnv",
    "TrainConfig",
    "TrainResult",
    "TrainingState",
    "Transition",
    "VideoConfig",
    "make_optimizer",
    "new_training_state",
    "ppo_loss",
    "ppo_multi_step",
    "ppo_step",
    "ppo_update",
    "train_ppo",
]
