"""Minibatch permutation indices on one device.

Port of ``nnx_ppo_tpu/parallel/permutation.py:26-168`` for a single
shard. Shuffled (the default): every epoch permutes all envs and cuts the
permutation into ``n_minibatches`` equal rows; the permutations come from
the caller's generator, or are injected as ``selectors`` (a test pins
them to the JAX package's). Unshuffled (``shuffle=False``): minibatch
``m`` is the contiguous env block ``[m·k, (m+1)·k)`` in every epoch, taken
as a slice (a view: no gather, no copy). The sequence buffers are
time-major ``[T, B, ...]`` (env axis 1) or, with ``batch_major``,
``[B, T, ...]`` (env axis 0: a shuffled minibatch gathers whole env
rows, one contiguous ``T·feat`` run each); the selectors do not depend
on the layout.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def minibatch_permutations(
    generator: torch.Generator, n_envs: int, n_epochs: int, n_minibatches: int
) -> torch.Tensor:
    """All epoch x minibatch env-index permutations: int64
    ``[n_epochs * n_minibatches, n_envs // n_minibatches]``; minibatch
    ``m`` of epoch ``e`` gathers ``x[:, inds[e * M + m]]``."""
    if n_envs % n_minibatches != 0:
        raise ValueError(
            f"n_envs ({n_envs}) must be divisible by n_minibatches ({n_minibatches})"
        )
    perms = [
        torch.randperm(n_envs, generator=generator, device=generator.device)
        for _ in range(n_epochs)
    ]
    return torch.stack(perms).reshape(n_epochs * n_minibatches, n_envs // n_minibatches)


def minibatch_plan(
    n_envs: int,
    n_epochs: int,
    n_minibatches: int,
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
        if n_envs % n_minibatches != 0:
            raise ValueError(
                f"n_envs ({n_envs}) must be divisible by n_minibatches ({n_minibatches})"
            )
        k_quota = n_envs // n_minibatches

        def block(m) -> slice:
            return slice(int(m) * k_quota, (int(m) + 1) * k_quota)

        def take_block(x, m):
            return x[block(m)]

        def take_block_seq(x, m):
            return x[:, block(m)]

        return (
            torch.arange(n_minibatches).repeat(n_epochs),
            take_block if batch_major else take_block_seq,
            take_block,
        )
    if selectors is None:
        if generator is None:
            raise ValueError("minibatch_plan needs a generator or selectors")
        selectors = minibatch_permutations(generator, n_envs, n_epochs, n_minibatches)
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
