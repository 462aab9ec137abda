"""Utilities (port of ``nnx_ppo_tpu/utils``): profiling."""

from nnx_ppo_tpu_torch.utils import profiling

__all__ = ["profiling"]
