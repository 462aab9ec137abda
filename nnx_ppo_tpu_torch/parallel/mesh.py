"""Data parallelism over ``torch.distributed``: one process per device.

Port of ``nnx_ppo_tpu/parallel/mesh.py``. The JAX package runs one GSPMD
program over a device mesh: env states, per-env carries and rollout
buffers sharded on the ``data`` axis along the env axis, parameters,
optimizer state and the loop key replicated, and the gradient,
normalizer and metric reductions implicit all-reduces. Here every device
has a process of its own, which holds its block of the envs, and each of
those reductions is an explicit collective at the matching place:

* the gradient average right after each minibatch's backward
  (:func:`average_gradients`, before the gradient norm and the
  optimizer's global-norm clipping, so both see the global gradient);
* the advantage statistics of each minibatch, the Normalizer's Welford
  fold and the logged metrics, as ``(count, mean, M2)`` triples gathered
  from every rank and merged in rank order
  (``ops/welford.py::all_merge_moments``);
* the checkpoint's batched leaves, gathered to rank 0 by
  ``algorithms/checkpointing.py``.

No rollout data crosses ranks: the minibatch plan is shard-local
(``permutation.py``), drawn by every rank from the replicated generator.

The mesh is a small object holding the process group, this rank, the
world size and the rank's ``torch.device``. gloo runs the collectives on
the CPU and NCCL on the card; NCCL refuses two ranks on one GPU, so two
ranks that share a card use gloo with CUDA tensors, staged through the
host (:meth:`Mesh.all_reduce_sum`, :meth:`Mesh.all_gather`).

Multi-process bring-up: start one process per device (``torchrun
--nproc_per_node=N`` sets each one's address, rank and world size), call
:func:`distributed_initialize` in each, then :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.core.struct import tree_map

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data-parallel axis over the ranks of a process group: this
    process is ``rank`` of ``world_size`` and computes on ``device``."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str
    axis_name: str = DATA_AXIS

    @property
    def shape(self) -> dict[str, int]:
        """``{axis_name: world_size}``, as JAX's ``mesh.shape``."""
        return {self.axis_name: self.world_size}

    def block(self, n: int) -> slice:
        """This rank's rows of a leading dim of ``n`` (divisible by the
        world size)."""
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        # gloo's CUDA support differs by collective and build: on gloo a
        # CUDA tensor goes through the host (the two-ranks-on-one-card
        # configuration only; NCCL takes it as it is).
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of ``x`` over every rank (a new tensor on
        ``x``'s device, the same on every rank)."""
        buf = self._staged(x).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(x.device)

    def barrier(self) -> None:
        """Return once every rank has reached this call."""
        self.all_reduce_sum(torch.zeros(1, device=self.device))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``[world_size,
        *x.shape]`` on ``x``'s device."""
        buf = self._staged(x).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.stack(parts).to(x.device)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = DATA_AXIS,
    device: Optional[Any] = None,
) -> Mesh:
    """1-D mesh over the ranks of the initialized process group.

    Raises when no group exists (call :func:`distributed_initialize`
    first), and when ``n_devices`` is given and differs from the group's
    world size: a mesh never shrinks or grows the world quietly.
    ``device`` defaults to ``cuda:LOCAL_RANK`` (modulo the visible cards;
    ``torchrun`` sets ``LOCAL_RANK``), which raises without a card; pass
    ``device="cpu"`` for CPU ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh({n_devices}) needs a process group: call "
            "distributed_initialize(...) first, once per process (torchrun sets "
            "the address, rank and world size)"
        )
    world_size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world_size:
        raise ValueError(
            f"make_mesh({n_devices}): the process group has {world_size} ranks, "
            "one device each"
        )
    if device is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards) if n_cards else "cuda"
    return Mesh(
        group=dist.group.WORLD,
        rank=rank,
        world_size=world_size,
        device=resolve_device(device),
        backend=str(dist.get_backend()),
        axis_name=axis_name,
    )


def distributed_initialize(**kwargs: Any) -> None:
    """Process bring-up: ``torch.distributed.init_process_group(**kwargs)``
    (``backend``, ``init_method`` or ``store``, ``rank``, ``world_size``;
    under ``torchrun`` none is needed but the backend). Call once per
    process before creating the mesh. No-op if a group already exists."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives on the mesh: this rank's block of its dim 0
    (``batched``) or all of it (replicated); on ``mesh.device``."""

    mesh: Mesh
    batched: bool

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full value ``x``."""
        if self.batched:
            x = x[self.mesh.block(x.shape[0])]
        return x.to(self.mesh.device)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, batched=False)


def batch_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """Shard dim 0 (the env axis) over the ranks; replicate the rest."""
    del axis_name  # one axis
    return Sharding(mesh, batched=True)


def _batch_leaf_sharding(leaf: Any, mesh: Mesh) -> Sharding:
    # Unbatched shared fields (scalars, or a leading dim not divisible by
    # the world size) are replicated, JAX's rule (mesh.py:58-64).
    if getattr(leaf, "ndim", 0) == 0 or leaf.shape[0] % mesh.world_size != 0:
        return replicated(mesh)
    return batch_sharded(mesh)


def training_state_shardings(
    training_state: Any, mesh: Mesh, axis_name: str = DATA_AXIS
) -> Any:
    """Per-leaf :class:`Sharding` tree for a (global) ``TrainingState``:
    env-batched leaves of the env states and carries batched, everything
    else (the modules, the optimizer, the generator, the step count)
    replicated."""
    del axis_name

    def batched(tree: Any) -> Any:
        return tree_map(lambda leaf: _batch_leaf_sharding(leaf, mesh), tree)

    return training_state.replace(
        networks=replicated(mesh),
        opt_state=replicated(mesh),
        network_states=batched(training_state.network_states),
        env_states=batched(training_state.env_states),
        generator=replicated(mesh),
        steps_taken=replicated(mesh),
    )


def global_device_put(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's part of ``x`` under ``sharding``. Every process holds
    the same full value (states are built from the shared seed), and
    each keeps its own block, as JAX's does across processes."""
    return sharding.place(x)


def place_replicated(tree: Any, mesh: Mesh) -> Any:
    """Every leaf whole, on ``mesh.device``."""
    return tree_map(lambda x: global_device_put(x, replicated(mesh)), tree)


def place_batched(tree: Any, mesh: Mesh, axis_name: str = DATA_AXIS) -> Any:
    """Each leaf's block of dim 0 (unbatched / indivisible leaves whole,
    the rule of :func:`training_state_shardings`)."""
    del axis_name
    return tree_map(lambda x: global_device_put(x, _batch_leaf_sharding(x, mesh)), tree)


def shard_training_state(
    training_state: Any, mesh: Mesh, axis_name: str = DATA_AXIS
) -> Any:
    """This rank's part of a global TrainingState (every rank built the
    same one from the shared seed): the env states and carries cut to the
    rank's block. Modules, optimizer and generator stay as they are, and
    must already be on ``mesh.device``."""
    del axis_name
    if training_state.generator.device.type != mesh.device.type:
        raise ValueError(
            f"the state's generator is on {training_state.generator.device}, the "
            f"mesh's device is {mesh.device}: build the state on the mesh's device"
        )
    return training_state.replace(
        network_states=place_batched(training_state.network_states, mesh),
        env_states=place_batched(training_state.env_states, mesh),
    )


def rank_generator(generator: torch.Generator, mesh: Optional[Mesh]) -> torch.Generator:
    """The generator this rank draws its rollout from. Without a mesh, or
    at world size 1, ``generator`` itself. Otherwise a fresh one on the
    same device, seeded by numpy's ``SeedSequence`` from a draw of
    ``generator`` (replicated: the same draw on every rank) and the rank,
    so that the ranks' envs and samplers draw apart and the state keeps
    one generator, the same on every rank."""
    if mesh is None or mesh.world_size == 1:
        return generator
    draw = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    seed = int(np.random.SeedSequence([draw, mesh.rank]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _check_local(leaf: Any, axis: int, mesh: Mesh, n_envs: Optional[int]) -> None:
    if n_envs is None:
        raise ValueError("under a mesh, pass n_envs (the global env count)")
    if getattr(leaf, "ndim", 0) <= axis:
        return
    n = leaf.shape[axis]
    local = n_envs // mesh.world_size
    if n != local and n % mesh.world_size == 0:
        raise ValueError(
            f"a leaf holds {n} envs along axis {axis}, where this rank's block is "
            f"{local} of {n_envs}: pass the rank's block (shard_training_state)"
        )


def constrain_batch(
    x: Any, mesh: Optional[Mesh], n_envs: Optional[int] = None, axis_name: str = DATA_AXIS
) -> Any:
    """JAX pins dim 0 of every batched leaf to the ``data`` axis here
    (``with_sharding_constraint``), so that GSPMD keeps the env axis
    sharded. With a process per device there is nothing to pin: each
    rank holds only its block. What can still go wrong is a leaf that
    holds all ``n_envs`` (global) envs where the rank's block belongs:
    a leaf whose dim 0 is a multiple of the world size (JAX's batched
    leaves) and not the rank's ``n_envs / world_size``. This raises on
    such a leaf and returns ``x`` unchanged. No-op without a mesh."""
    del axis_name
    if mesh is not None:
        tree_map(lambda leaf: _check_local(leaf, 0, mesh, n_envs), x)
    return x


def constrain_time_batch(
    x: Any, mesh: Optional[Mesh], n_envs: Optional[int] = None, axis_name: str = DATA_AXIS
) -> Any:
    """:func:`constrain_batch` for ``[T, B, ...]`` rollout buffers: the
    env axis is dim 1."""
    del axis_name
    if mesh is not None:
        tree_map(lambda leaf: _check_local(leaf, 1, mesh, n_envs), x)
    return x


def average_gradients(params: Any, mesh: Optional[Mesh]) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks, in
    one all-reduce of every gradient packed into one buffer. No-op
    without a mesh."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    total = mesh.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    mean = total / mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(mean[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
