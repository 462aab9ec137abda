"""Carry weights and data across from the JAX package.

No JAX counterpart. The JAX package's modules are pytrees whose field
names match the port's attribute names (``layers``, ``action``,
``value``, ``components`` and the child names of the named containers,
``kernel``, ``bias``, ``mean``, ``M2``, ``counter``; the recurrent
cells' ``wi``, ``wh``, ``bias``, ``initial_h``, ``initial_c``; a
population graph's ``transforms``, one per connection), and the kernels
keep their ``[in, out]`` layout here, so weights load by name with no
transpose. A pytree ``Normalizer``'s ``mean`` / ``M2`` trees load key by
key into its ``StatTree`` buffers. A ``PopulationGraph`` loads only into
a graph with the same populations (names, sizes, buffer lengths) and the
same connections (source, destination, delay) in the same order.
:func:`legged_state_data` turns the ``data`` of a
vmapped JAX ``LeggedJoystick`` state into the port's batched one, and
:func:`heightgrid_from_fields` the fields of a JAX ``HeightGrid`` into the
port's, so that both run on the same table. This module takes numpy
leaves only: the caller
turns JAX arrays into numpy (for example
``jax.tree.map(np.asarray, partition_params(net)[0])``) and nothing here
imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from nnx_ppo_tpu_torch.networks.graph import PopulationGraph
from nnx_ppo_tpu_torch.physics.randomize import FIELDS as DR_FIELDS
from nnx_ppo_tpu_torch.physics.randomize import DomainParams
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid


def _child(node: Any, name: str) -> Any:
    """Field ``name`` of a nested-dict node or of an object node (such as
    a JAX module dataclass holding numpy leaves); None when absent."""
    if node is None:
        return None
    if isinstance(node, Mapping):
        return node.get(name)
    return getattr(node, name, None)


@torch.no_grad()
def load_jax_leaves(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the numpy leaves of ``tree`` into ``module``'s parameters and
    buffers of the same names, recursively; ``None`` leaves (such as the
    positions a params/stats partition leaves empty) are skipped.
    Returns ``module``."""
    if isinstance(module, PopulationGraph):
        _check_graph_structure(module, tree)
    tensors = list(module.named_parameters(recurse=False)) + list(
        module.named_buffers(recurse=False)
    )
    for name, tensor in tensors:
        value = _child(tree, name)
        if value is None:
            continue
        value = np.asarray(value)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{type(module).__name__}.{name}: expected shape "
                f"{tuple(tensor.shape)}, got {value.shape}"
            )
        tensor.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    for name, child in module.named_children():
        subtree = _child(tree, name)
        if isinstance(child, nn.ModuleList):
            if subtree is not None and len(subtree) != len(child):
                raise ValueError(
                    f"{type(module).__name__}.{name}: {len(child)} layers, "
                    f"tree has {len(subtree)}"
                )
            for i, layer in enumerate(child):
                load_jax_leaves(layer, None if subtree is None else subtree[i])
        else:
            load_jax_leaves(child, subtree)
    return module


def _check_graph_structure(graph: PopulationGraph, tree: Any) -> None:
    """Populations and connections of the JAX graph ``tree`` by name."""
    specs = {
        "populations": lambda p: (p.name, p.size, p.max_outgoing_delay),
        "connections": lambda c: (c.src, c.dst, c.delay),
    }
    for field, spec in specs.items():
        theirs = _child(tree, field)
        if theirs is None:
            continue
        ours, theirs = [spec(x) for x in getattr(graph, field)], [spec(x) for x in theirs]
        if ours != theirs:
            raise ValueError(f"PopulationGraph.{field}: {ours} here, {theirs} in the tree")


def to_torch(tree: Any, device: Optional[torch.device | str] = None) -> Any:
    """Nested dicts / lists / tuples of numpy arrays -> the same nest of
    tensors on ``device`` (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def legged_state_data(data: Mapping, device: Optional[torch.device | str] = None) -> dict:
    """``State.data`` of a batched (vmapped) JAX ``LeggedJoystick`` state,
    as numpy leaves, -> the port's ``State.data``: ``qpos``, ``qvel``,
    ``cmd``, ``prev_action`` as ``[B, ...]`` tensors and ``dr`` as a
    :class:`DomainParams` of ``[B]`` tensors. The JAX per-env ``key`` has
    no counterpart (the port draws from one generator) and is dropped."""
    out = {k: to_torch(data[k], device) for k in ("qpos", "qvel", "cmd", "prev_action")}
    dr = data.get("dr")
    if dr is not None:
        out["dr"] = DomainParams(**{name: to_torch(_child(dr, name), device) for name in DR_FIELDS})
    return out


def heightgrid_from_fields(data, x0: float, y0: float, dx: float, dy: float) -> HeightGrid:
    """The port's :class:`HeightGrid` from the fields of a JAX one
    (``data`` as numpy): the same float32 table, origin and spacing."""
    return HeightGrid(
        data=np.array(data, dtype=np.float32), x0=float(x0), y0=float(y0), dx=float(dx), dy=float(dy)
    )
