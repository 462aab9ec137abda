"""Minibatch permutation indices, shard-locality aware.

Port of ``nnx_ppo_tpu/parallel/permutation.py``. Shuffled (the default):
with one shard, every epoch permutes all envs and cuts the permutation
into ``n_minibatches`` equal rows; with ``n_shards > 1`` each shard block
is permuted on its own and minibatch ``m`` takes an equal slice of every
block, so that under data parallelism a minibatch never reaches into
another rank's envs (JAX ``permutation.py:26-76``). The permutations come
from the caller's generator, or are injected as ``selectors`` (a test
pins them to the JAX package's). Unshuffled (``shuffle=False``):
minibatch ``m`` is the contiguous env block ``[m·k, (m+1)·k)`` of every
shard block in every epoch (with one shard a slice: a view, no gather,
no copy). The sequence buffers are time-major ``[T, B, ...]`` (env axis
1) or, with ``batch_major``, ``[B, T, ...]`` (env axis 0: a shuffled
minibatch gathers whole env rows, one contiguous ``T·feat`` run each);
the selectors do not depend on the layout.

Under a data-parallel mesh every rank draws the same global plan from a
generator replicated across the ranks and keeps the indices of its own
block, made local (:func:`shard_local_selectors`).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def _check_divisible(n_envs: int, n_minibatches: int, n_shards: int) -> int:
    """JAX's divisibility errors; returns the minibatch size."""
    if n_envs % n_minibatches != 0:
        raise ValueError(
            f"n_envs ({n_envs}) must be divisible by n_minibatches ({n_minibatches})"
        )
    minibatch_size = n_envs // n_minibatches
    if n_shards > 1:
        if n_envs % n_shards != 0:
            raise ValueError(
                f"n_envs ({n_envs}) must be divisible by n_shards ({n_shards})"
            )
        if minibatch_size % n_shards != 0:
            raise ValueError(
                "minibatch size must be divisible by n_shards for shard-local "
                f"minibatching (got {minibatch_size} % {n_shards})"
            )
    return minibatch_size


def minibatch_permutations(
    generator: torch.Generator,
    n_envs: int,
    n_epochs: int,
    n_minibatches: int,
    n_shards: int = 1,
) -> torch.Tensor:
    """All epoch x minibatch env-index permutations: int64
    ``[n_epochs * n_minibatches, n_envs // n_minibatches]``; minibatch
    ``m`` of epoch ``e`` gathers ``x[:, inds[e * M + m]]``. With
    ``n_shards > 1`` each row holds ``k = n_envs / (n_shards · M)``
    indices of every shard block in turn (block 0's first)."""
    minibatch_size = _check_divisible(n_envs, n_minibatches, n_shards)
    dev = generator.device
    epochs = []
    for _ in range(n_epochs):
        if n_shards == 1:
            epochs.append(torch.randperm(n_envs, generator=generator, device=dev))
            continue
        per_shard = n_envs // n_shards
        local = torch.stack([torch.randperm(per_shard, generator=generator, device=dev)
                             for _ in range(n_shards)])
        offsets = (torch.arange(n_shards, device=dev) * per_shard)[:, None]
        by_minibatch = (local + offsets).reshape(n_shards, n_minibatches, -1)
        epochs.append(by_minibatch.transpose(0, 1).reshape(n_minibatches, minibatch_size))
    return torch.stack(epochs).reshape(n_epochs * n_minibatches, minibatch_size)


def shard_local_selectors(
    selectors: torch.Tensor, n_envs: int, n_shards: int, shard: int
) -> torch.Tensor:
    """Shard ``shard``'s part of a shard-local plan's ``selectors`` (from
    :func:`minibatch_permutations` with ``n_shards``), as indices into
    that shard's own block of ``n_envs / n_shards`` envs."""
    k = selectors.shape[1] // n_shards
    return selectors[:, shard * k:(shard + 1) * k] - shard * (n_envs // n_shards)


def minibatch_plan(
    n_envs: int,
    n_epochs: int,
    n_minibatches: int,
    n_shards: int = 1,
    *,
    shuffle: bool = True,
    generator: Optional[torch.Generator] = None,
    selectors: Optional[torch.Tensor] = None,
    batch_major: bool = False,
) -> tuple[
    torch.Tensor,
    Callable[[Any, torch.Tensor], Any],
    Callable[[Any, torch.Tensor], Any],
]:
    """``(selectors, take_seq, take_batch)`` for the E·M updates
    (``permutation.py:80-165``).

    ``take_seq`` extracts a minibatch from a sequence buffer, time-major
    ``[T, B, ...]`` or, with ``batch_major``, ``[B, T, ...]``;
    ``take_batch`` from a per-env ``[B, ...]`` leaf. Pass ``selectors`` to
    use given permutations instead of drawing them. With ``shuffle=False``
    the selectors are the minibatch numbers ``tile(arange(M), E)`` (on the
    host) and the extractors slice.
    """
    if not shuffle:
        if selectors is not None:
            raise ValueError("selectors cannot be injected with shuffle=False")
        if n_envs % n_shards != 0:
            raise ValueError(
                f"n_envs ({n_envs}) must be divisible by n_shards ({n_shards})"
            )
        per_block = n_envs // n_shards
        if per_block % n_minibatches != 0:
            raise ValueError(
                "per-shard env count must be divisible by n_minibatches "
                f"(got {per_block} % {n_minibatches})"
            )
        k_quota = per_block // n_minibatches

        def block_slice(x, m, axis: int):
            lo = int(m) * k_quota
            if n_shards == 1:
                return x.narrow(axis, lo, k_quota)
            blocks = x.unflatten(axis, (n_shards, per_block))
            return blocks.narrow(axis + 1, lo, k_quota).flatten(axis, axis + 1)

        def take_block(x, m):
            return block_slice(x, m, 0)

        def take_block_seq(x, m):
            return block_slice(x, m, 1)

        return (
            torch.arange(n_minibatches).repeat(n_epochs),
            take_block if batch_major else take_block_seq,
            take_block,
        )
    if selectors is None:
        if generator is None:
            raise ValueError("minibatch_plan needs a generator or selectors")
        selectors = minibatch_permutations(
            generator, n_envs, n_epochs, n_minibatches, n_shards
        )
    elif tuple(selectors.shape) != (n_epochs * n_minibatches, n_envs // n_minibatches):
        raise ValueError(
            f"selectors must be [{n_epochs * n_minibatches}, "
            f"{n_envs // n_minibatches}], got {tuple(selectors.shape)}"
        )

    def take_seq(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
        return x[:, inds]

    def take_batch(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
        return x[inds]

    return selectors, take_batch if batch_major else take_seq, take_batch
