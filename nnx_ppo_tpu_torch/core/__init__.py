"""Tree helpers and device selection (port of ``nnx_ppo_tpu/core``)."""

from nnx_ppo_tpu_torch.core.device import DeviceConstants, resolve_device
from nnx_ppo_tpu_torch.core.struct import (
    tree_leaves,
    tree_map,
    tree_stack,
    tree_where,
)

__all__ = [
    "DeviceConstants",
    "resolve_device",
    "tree_leaves",
    "tree_map",
    "tree_stack",
    "tree_where",
]
