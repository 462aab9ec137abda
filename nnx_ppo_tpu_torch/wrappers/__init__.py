"""Env wrappers (port of ``nnx_ppo_tpu/wrappers``)."""

from nnx_ppo_tpu_torch.wrappers.episode_wrapper import EpisodeWrapper

__all__ = ["EpisodeWrapper"]
