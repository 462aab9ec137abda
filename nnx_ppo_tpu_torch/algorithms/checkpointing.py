"""Checkpointing: exact-resume snapshots of the whole training state.

Port of ``nnx_ppo_tpu/algorithms/checkpointing.py`` (``CheckpointCallback``
:42, ``CHECKPOINT_FORMAT_VERSION`` :48, ``_path_name`` / ``_named_leaves``
:58-103, ``save_checkpoint`` :123, ``make_checkpoint_fn`` :156,
``load_checkpoint`` :172), with JAX's layout and its exact-resume
guarantee, env states and per-env carries included::

    {directory}/step_{step:010d}/
        state/tensors.pt   one torch.save of a flat {name: tensor} dict,
                           each tensor under its structure-derived name
                           (``opt_state.state.networks.layers.1.kernel.exp_avg``)
        metadata.pkl       format_version, the ordered leaf names,
                           n_leaves, step, the pickled config, and the
                           device type of each generator's state

The JAX package stores its arrays with orbax, which imports JAX; the
port uses ``torch.save`` and reads with ``torch.load(weights_only=True)``,
which refuses anything but tensors and plain containers, so the config
stays in ``metadata.pkl`` as in JAX.

What a state holds, and how each part is named (core/struct.py's
:func:`~nnx_ppo_tpu_torch.core.struct.named_leaves`): an ``nn.Module`` by
its ``state_dict`` (parameters and buffers, such as a ``Normalizer``'s
Welford statistics); a ``torch.optim.Optimizer`` by its ``state_dict``
with each per-parameter entry keyed by the parameter's name in its module
rather than its index, so that another structure fails by name, and each
param group's ``update_count`` (the ``anneal_lr`` schedule's step) and
``lr``; a ``torch.Generator`` by ``get_state()``, which stands in for
JAX's key leaves; Python numbers (``steps_taken``) as 0-d tensors; and
every tensor of the carries and env states as it is, NaN sentinels
included. ``save_checkpoint`` takes a ``TrainingState``, a
``DistillationState``, a bare ``nn.Module`` (the policy-only export) or
any tree of these.

``load_checkpoint`` restores by name into a template of the same
structure: its tensors onto the template's devices, its modules,
optimizers and generators in place. A generator's state is valid only
for a generator of the device type that saved it (a CUDA generator's
seed and offset, a CPU one's Mersenne-Twister state), so loading one into
a generator of another device type raises. The port never wrote JAX's
v1 (integer-indexed) format and reads only v2.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional, Protocol, runtime_checkable

import torch
from torch import nn

from nnx_ppo_tpu_torch.core.struct import named_leaves, path_name, tree_children

CHECKPOINT_FORMAT_VERSION = 2
TENSORS_FILE = "tensors.pt"


@runtime_checkable
class CheckpointCallback(Protocol):
    """Checkpoint callback protocol (matches train_ppo's checkpoint_fn)."""

    def __call__(self, training_state: Any, step: int) -> None: ...


def _parameter_names(tree: Any, path: tuple = ()) -> dict[int, str]:
    """``id(parameter) -> name`` for the parameters of every module in
    ``tree``, named by the module's path and the parameter's own name."""
    if isinstance(tree, nn.Module):
        return {id(p): path_name(path + tuple(name.split(".")))
                for name, p in tree.named_parameters()}
    names: dict[int, str] = {}
    for key, child in tree_children(tree) or ():
        names.update(_parameter_names(child, path + (key,)))
    return names


def _optimizer_index_names(opt: torch.optim.Optimizer, names: dict[int, str]) -> dict[int, str]:
    """The optimizer's ``state_dict`` parameter indices -> parameter names."""
    out = {}
    for group, group_sd in zip(opt.param_groups, opt.state_dict()["param_groups"]):
        for p, index in zip(group["params"], group_sd["params"]):
            if id(p) not in names:
                raise ValueError(
                    "the optimizer holds a parameter that no module of the "
                    "checkpointed state owns; save the module with it"
                )
            out[index] = names[id(p)]
    return out


def _optimizer_tree(opt: torch.optim.Optimizer, names: dict[int, str]) -> dict:
    sd = opt.state_dict()
    index_names = _optimizer_index_names(opt, names)
    return {
        "state": {index_names[i]: dict(entry) for i, entry in sd["state"].items()},
        "param_groups": [
            {"update_count": g.get("update_count", 0), "lr": float(g["lr"])}
            for g in sd["param_groups"]
        ],
    }


def _storable(node: Any, names: dict[int, str], generators: dict, path: tuple = ()) -> Any:
    """``node`` as a tree of tensors and modules: optimizers as their
    named state, generators as their state (recording each one's device
    type in ``generators`` under its name), numbers as 0-d tensors."""
    if node is None or torch.is_tensor(node) or isinstance(node, nn.Module):
        return node
    if isinstance(node, torch.optim.Optimizer):
        return _storable(_optimizer_tree(node, names), names, generators, path)
    if isinstance(node, torch.Generator):
        generators[path_name(path)] = node.device.type
        return node.get_state()
    if isinstance(node, (bool, int, float)):
        return torch.tensor(node, dtype=torch.float64 if isinstance(node, float) else None)
    children = tree_children(node)
    if children is None:
        raise TypeError(f"cannot checkpoint a {type(node).__name__} at {path_name(path)!r}")
    return {key: _storable(child, names, generators, path + (key,)) for key, child in children}


def _flat(tree: Any) -> tuple[list[tuple[str, Any]], dict[str, str]]:
    """Named storable leaves of ``tree`` and its generators' device types."""
    generators: dict[str, str] = {}
    storable = _storable(tree, _parameter_names(tree), generators)
    return named_leaves(storable), generators


def save_checkpoint(
    step_dir: str,
    training_state: Any,
    step: int,
    config: Optional[Any] = None,
) -> None:
    """Write one checkpoint directory (``state/`` + ``metadata.pkl``).
    ``training_state`` is a TrainingState, a DistillationState, a module
    or any tree of those parts (the format is generic named-leaf
    storage). Each tensor is copied to the host once, compactly (a view
    does not drag its whole storage into the file)."""
    os.makedirs(os.path.join(step_dir, "state"), exist_ok=True)
    named, generators = _flat(training_state)
    tensors = {name: leaf.detach().to("cpu", copy=True) for name, leaf in named}
    torch.save(tensors, os.path.join(step_dir, "state", TENSORS_FILE))
    metadata = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "leaf_names": [name for name, _ in named],
        "n_leaves": len(named),
        "step": step,
        "config": config,
        "generators": generators,
    }
    with open(os.path.join(step_dir, "metadata.pkl"), "wb") as f:
        pickle.dump(metadata, f)


def make_checkpoint_fn(directory: str, config: Optional[Any] = None) -> CheckpointCallback:
    """Checkpoint callback writing ``{directory}/step_{step:010d}/``.
    Resume via :func:`load_checkpoint`."""
    abs_directory = os.path.abspath(directory)

    def checkpoint_fn(training_state: Any, step: int) -> None:
        step_dir = os.path.join(abs_directory, f"step_{step:010d}")
        save_checkpoint(step_dir, training_state, step, config)

    return checkpoint_fn


def _restore(node: Any, path: tuple, flat: dict, names: dict[int, str]) -> Any:
    """``node`` (the template) with every leaf taken from ``flat`` by
    name: tensors onto the template's devices, modules, optimizers and
    generators restored in place."""
    if node is None:
        return None
    if torch.is_tensor(node):
        return flat[path_name(path)].to(node.device)
    if isinstance(node, nn.Module):
        node.load_state_dict(
            {k: flat[path_name(path + tuple(k.split(".")))] for k in node.state_dict()}
        )
        return node
    if isinstance(node, torch.optim.Optimizer):
        tree = _restore(_storable(_optimizer_tree(node, names), names, {}), path, flat, names)
        index_of = {name: i for i, name in _optimizer_index_names(node, names).items()}
        sd = node.state_dict()
        sd["state"] = {index_of[name]: entry for name, entry in tree["state"].items()}
        for group, saved in zip(sd["param_groups"], tree["param_groups"].values()):
            if "update_count" in group:
                group["update_count"] = int(saved["update_count"])
            group["lr"] = float(saved["lr"])
        node.load_state_dict(sd)
        return node
    if isinstance(node, torch.Generator):
        node.set_state(flat[path_name(path)])
        return node
    if isinstance(node, (bool, int, float)):
        return type(node)(flat[path_name(path)].item())
    if isinstance(node, dict):
        return {k: _restore(v, path + (k,), flat, names) for k, v in node.items()}
    if hasattr(node, "_fields"):
        return type(node)(*(_restore(v, path + (k,), flat, names) for k, v in tree_children(node)))
    if isinstance(node, (tuple, list)):
        return type(node)(_restore(v, path + (i,), flat, names) for i, v in enumerate(node))
    return dataclasses.replace(
        node, **{k: _restore(v, path + (k,), flat, names) for k, v in tree_children(node)}
    )


def load_checkpoint(path: str, training_state: Any) -> dict[str, Any]:
    """Load a checkpoint saved by :func:`make_checkpoint_fn` or
    :func:`save_checkpoint`.

    ``training_state`` is a structural template (for example from
    ``new_training_state`` with the same architecture and ``n_envs``):
    its values are irrelevant, its devices are kept, and its modules,
    optimizers and generators are restored in place. Raises JAX's
    ``ValueError("... mismatch ...")`` when the two name sets differ, a
    leaf's shape or dtype differs, or a generator's device type differs.

    Returns ``{"training_state": ..., "step": int, "config": ...}``.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, "metadata.pkl"), "rb") as f:
        metadata = pickle.load(f)
    version = metadata.get("format_version", 1)
    if version != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{version}: the port reads format "
            f"v{CHECKPOINT_FORMAT_VERSION} only (it never wrote v1)"
        )

    named, generators = _flat(training_state)
    template_names = [name for name, _ in named]
    ckpt_names = metadata["leaf_names"]
    if set(template_names) != set(ckpt_names):
        missing = sorted(set(ckpt_names) - set(template_names))
        extra = sorted(set(template_names) - set(ckpt_names))
        raise ValueError(
            "checkpoint/template structure mismatch:\n"
            f"  in checkpoint but not template: {missing[:10]}\n"
            f"  in template but not checkpoint: {extra[:10]}\n"
            "(named-leaf layout, format v2 — restoring into a "
            "different architecture is not supported)"
        )
    for name, device_type in generators.items():
        saved = metadata["generators"].get(name)
        if saved != device_type:
            raise ValueError(
                f"generator {name!r}: device type mismatch, the checkpoint holds "
                f"a {saved} generator's state and the template's generator is on "
                f"{device_type}; load into a template built on a {saved} device"
            )

    flat = torch.load(os.path.join(path, "state", TENSORS_FILE), map_location="cpu",
                      weights_only=True)
    for name, leaf in named:
        got = flat[name]
        if got.shape != leaf.shape or got.dtype != leaf.dtype:
            raise ValueError(
                f"checkpoint/template leaf mismatch at {name!r}: "
                f"{tuple(got.shape)} {got.dtype} in the checkpoint, "
                f"{tuple(leaf.shape)} {leaf.dtype} in the template"
            )
    restored = _restore(training_state, (), flat, _parameter_names(training_state))
    return {
        "training_state": restored,
        "step": metadata["step"],
        "config": metadata["config"],
    }
