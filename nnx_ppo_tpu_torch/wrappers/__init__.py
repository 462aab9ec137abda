"""Env wrappers (port of ``nnx_ppo_tpu/wrappers``)."""

from nnx_ppo_tpu_torch.wrappers.episode_wrapper import EpisodeWrapper
from nnx_ppo_tpu_torch.wrappers.reward_scaling_wrapper import RewardScalingWrapper

__all__ = ["EpisodeWrapper", "RewardScalingWrapper"]
