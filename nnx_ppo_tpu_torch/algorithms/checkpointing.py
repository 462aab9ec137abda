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

Under a data-parallel mesh (``mesh=``, ``parallel/mesh.py``) a checkpoint
is the same file that one process writes: every rank gathers the batched
leaves (the env states and per-env carries, this rank's block each) in
rank order, and rank 0 writes; a load reads the whole file on every rank
and keeps each batched leaf's block for the rank. So a run saved at one
world size resumes at another (JAX ``tests/test_checkpoint_topology.py``).
The generator is replicated on every rank, so rank 0's is the run's.
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
# The state fields whose leaves are batched along the env axis under a
# mesh (``parallel/mesh.py::training_state_shardings`` and the
# distillation state's ``place_batched`` fields).
BATCHED_FIELDS = ("env_states", "network_states", "student_states", "teacher_states")


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


def _is_batched(name: str, leaf: torch.Tensor, n_local: Optional[int]) -> bool:
    """A leaf of a batched state field whose dim 0 is the env axis."""
    return (n_local is not None and name.split(".")[0] in BATCHED_FIELDS
            and leaf.ndim >= 1 and leaf.shape[0] == n_local)


def _gathered(name: str, leaf: torch.Tensor, mesh: Any, n_local: Optional[int]) -> torch.Tensor:
    """``leaf`` whole: every rank's block in rank order, if batched."""
    leaf = leaf.detach()
    if mesh is None or not _is_batched(name, leaf, n_local):
        return leaf
    # bool as bytes: not every backend reduces or gathers bool tensors.
    parts = mesh.all_gather(leaf.view(torch.uint8) if leaf.dtype == torch.bool else leaf)
    parts = parts.view(torch.bool) if leaf.dtype == torch.bool else parts
    return parts.reshape((-1,) + tuple(leaf.shape[1:]))


def _local_env_count(training_state: Any) -> Optional[int]:
    env_states = getattr(training_state, "env_states", None)
    return None if env_states is None else int(env_states.done.shape[0])


def save_checkpoint(
    step_dir: str,
    training_state: Any,
    step: int,
    config: Optional[Any] = None,
    mesh: Optional[Any] = None,
) -> None:
    """Write one checkpoint directory (``state/`` + ``metadata.pkl``).
    ``training_state`` is a TrainingState, a DistillationState, a module
    or any tree of those parts (the format is generic named-leaf
    storage). Each tensor is copied to the host once, compactly (a view
    does not drag its whole storage into the file). With a ``mesh`` every
    rank must call it: the batched leaves are gathered and rank 0 writes
    the file, which every rank can read when this returns."""
    named, generators = _flat(training_state)
    n_local = _local_env_count(training_state)
    tensors = {name: _gathered(name, leaf, mesh, n_local).to("cpu", copy=True)
               for name, leaf in named}
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return
    os.makedirs(os.path.join(step_dir, "state"), exist_ok=True)
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
    if mesh is not None:
        mesh.barrier()


def make_checkpoint_fn(
    directory: str, config: Optional[Any] = None, mesh: Optional[Any] = None
) -> CheckpointCallback:
    """Checkpoint callback writing ``{directory}/step_{step:010d}/``
    (with a ``mesh``, by rank 0 after the gather, :func:`save_checkpoint`).
    Resume via :func:`load_checkpoint`."""
    abs_directory = os.path.abspath(directory)

    def checkpoint_fn(training_state: Any, step: int) -> None:
        step_dir = os.path.join(abs_directory, f"step_{step:010d}")
        save_checkpoint(step_dir, training_state, step, config, mesh)

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


def load_checkpoint(path: str, training_state: Any, mesh: Optional[Any] = None) -> dict[str, Any]:
    """Load a checkpoint saved by :func:`make_checkpoint_fn` or
    :func:`save_checkpoint`.

    ``training_state`` is a structural template (for example from
    ``new_training_state`` with the same architecture and ``n_envs``):
    its values are irrelevant, its devices are kept, and its modules,
    optimizers and generators are restored in place. With a ``mesh`` the
    template is this rank's (``new_training_state(..., mesh=mesh)``) and
    each batched leaf of the file, written at any world size, gives the
    rank its block. Raises JAX's
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
    n_local = _local_env_count(training_state)
    for name, leaf in named:
        got = flat[name]
        if mesh is not None and _is_batched(name, leaf, n_local) and got.ndim >= 1:
            got = flat[name] = got[mesh.block(got.shape[0])]
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
