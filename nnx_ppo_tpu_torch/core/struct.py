"""Tree helpers for nested carries, extras and env states.

Ports what the training path needs of ``nnx_ppo_tpu/core/struct.py``.
The JAX package's param/stats/rng field roles have no counterpart here:
trainable leaves are ``nn.Parameter`` s and running statistics are
registered buffers, so ``module.parameters()`` is the params partition.

A tree is a nest of ``dict``, ``tuple``, ``list`` and dataclass nodes
with tensor leaves. ``None`` is an empty node, as in JAX: mapping over it
gives ``None`` and it contributes no leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and trees of the same shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
            },
        )
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves of ``tree`` in traversal order (``None`` nodes skipped)."""
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def tree_stack(trees: list) -> Any:
    """Stack a list of same-shaped trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_where(cond: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """Batched tree select: ``where(cond[B], on_true, on_false)`` with
    ``cond`` broadcast over each leaf's trailing dims.

    Leaves whose leading dim differs from ``cond`` (unbatched shared
    fields) pass through from ``on_true`` unchanged, as in
    ``nnx_ppo_tpu/core/struct.py:204``.
    """

    def broadcast_where(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.ndim == 0 or x.shape[0] != cond.shape[0]:
            return x
        c = cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim))
        return torch.where(c, x, y)

    return tree_map(broadcast_where, on_true, on_false)
