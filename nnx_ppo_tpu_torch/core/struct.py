"""Tree helpers for nested carries, extras and env states.

Ports what the training path needs of ``nnx_ppo_tpu/core/struct.py``,
and the structure-derived leaf names of a checkpoint
(``nnx_ppo_tpu/algorithms/checkpointing.py:58-103``, ``_path_name`` and
``_named_leaves``): :func:`tree_flatten_with_path` and
:func:`named_leaves`.
The JAX package's param/stats/rng field roles have no counterpart here:
trainable leaves are ``nn.Parameter`` s and running statistics are
registered buffers, so ``module.parameters()`` is the params partition.

A tree is a nest of ``dict``, ``tuple``, ``list`` (a NamedTuple keeps its
type) and dataclass nodes with tensor leaves. ``None`` is an empty node, as in JAX: mapping over it
gives ``None`` and it contributes no leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and trees of the same shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
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


def tree_children(node: Any) -> Optional[list[tuple[Any, Any]]]:
    """``(key, child)`` pairs of a container node: a dict's keys, a
    NamedTuple's or dataclass's field names, a list's or tuple's indices;
    ``None`` for anything else (a leaf)."""
    if isinstance(node, dict):
        return list(node.items())
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def tree_flatten_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in traversal order, ``path`` a
    tuple of keys (JAX's ``tree_flatten_with_path``): the keys of
    :func:`tree_children`, and an ``nn.Module``'s ``state_dict`` names,
    split at their dots (its parameters and buffers, each once). ``None``
    gives no leaf."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [
            (path + tuple(name.split(".")), value)
            for name, value in tree.state_dict(keep_vars=True).items()
        ]
    children = tree_children(tree)
    if children is None:
        return [(path, tree)]
    out: list[tuple[tuple, Any]] = []
    for key, value in children:
        out.extend(tree_flatten_with_path(value, path + (key,)))
    return out


def path_name(path: tuple) -> str:
    """A leaf's name from its path, e.g.
    ``opt_state.state.networks.layers.1.kernel.exp_avg``: the keys joined
    by '.', a '/' inside a key written '⁄' (JAX's ``_path_name``)."""
    return ".".join(str(p).replace("/", "⁄") for p in path) if path else "<root>"


def named_leaves(tree: Any) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs of ``tree``, each name unique. Raises JAX's
    ``ValueError`` when two paths render to the same name (a dict key with
    a '.' can), since restoring by name would then cross-assign them."""
    named = [(path_name(path), leaf) for path, leaf in tree_flatten_with_path(tree)]
    seen: set[str] = set()
    for name, _ in named:
        if name in seen:
            raise ValueError(
                f"Checkpoint leaf name collision: {name!r} is produced "
                "by more than one key path. Rename the offending dict "
                "key (avoid '.' and '/' in keys) so every leaf has a unique path."
            )
        seen.add(name)
    return named
