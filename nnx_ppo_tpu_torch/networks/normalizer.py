"""Online (Welford) input normalizer.

Port of ``nnx_ppo_tpu/networks/normalizer.py``. The forward is read-only
on the running statistics and emits its raw input as ``rollout_extras``;
:meth:`update_statistics` folds the ``[T, B, f]`` history in once per
training step, after the gradient updates. Before the first fold the
standard deviation is 10.0; ``epsilon`` floors the variance, not the std
(``normalizer.py:60-69``). Statistics are float32 buffers (``mean``,
``M2``, ``counter``), so they move with ``.to(device)`` and are excluded
from ``parameters()``.

Observations are one tensor (``shape`` an int or a tuple) or a dict of
them (``shape`` a dict of ints / tuples, nested dicts allowed;
``normalizer.py:47-58``): then ``mean`` and ``M2`` are :class:`StatTree`
modules holding one buffer per key, every leaf keeps its own Welford
moments and all leaves share one ``counter``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule
from nnx_ppo_tpu_torch.ops.welford import batch_moments, merge_moments


def _zeros(shape: Any) -> Any:
    """Zeros for a shape (int or tuple) or a dict of shapes."""
    if isinstance(shape, dict):
        return {k: _zeros(v) for k, v in shape.items()}
    return torch.zeros(shape)


class StatTree(nn.Module):
    """A dict of statistics as buffers named by key (nested dicts as child
    modules), so that they move with the module and load by name."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, StatTree(value))
            else:
                self.register_buffer(key, value)

    def tree(self) -> dict:
        return {
            k: v.tree() if isinstance(v := getattr(self, k), StatTree) else v
            for k in self._keys
        }


class Normalizer(StatefulModule):
    """Standardizes ``x`` (a tensor or a dict of tensors) to zero mean /
    unit variance with running statistics."""

    def __init__(self, shape: Any, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        if isinstance(shape, (int, tuple, list)):
            self.register_buffer("mean", torch.zeros(shape))
            self.register_buffer("M2", torch.zeros(shape))
        else:
            shape = dict(shape)
            self.mean = StatTree(_zeros(shape))
            self.M2 = StatTree(_zeros(shape))
        self.register_buffer("counter", torch.zeros(()))

    @classmethod
    def create(cls, shape: Any, epsilon: float = 1e-6) -> "Normalizer":
        return cls(shape, epsilon)

    def _stats(self) -> tuple[Any, Any]:
        """(mean, M2) as tensors or dicts of tensors."""
        if isinstance(self.mean, StatTree):
            return self.mean.tree(), self.M2.tree()
        return self.mean, self.M2

    def _std(self, m2: Optional[torch.Tensor] = None) -> Any:
        """The standard deviation of one leaf's ``M2``, or with no
        argument of every leaf (a tensor, or a tree like ``M2``)."""
        if m2 is None:
            return tree_map(self._std, self._stats()[1])
        count = torch.clamp(self.counter, min=1.0)
        std = torch.sqrt(torch.clamp(m2 / count, min=self.epsilon))
        return torch.where(self.counter > 0, std, 10.0)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        mean, m2 = self._stats()
        output = tree_map(lambda v, m, s: (v - m) / self._std(s), x, mean, m2)
        return ModuleOutput((), output, 0.0, {}, rollout_extras=x)

    @property
    def replay_time_static(self) -> bool:
        return True

    @torch.no_grad()
    def update_statistics(self, rollout_extras: Any) -> "Normalizer":
        """Fold the ``[T, B, *feat]`` history of every leaf into its
        running moments; the shared counter advances by ``T * B``."""

        def fold(mean: torch.Tensor, m2: torch.Tensor, history: torch.Tensor):
            total, new_mean, new_m2 = merge_moments(
                (self.counter, mean, m2), batch_moments(history, n_batch_axes=2)
            )
            mean.copy_(new_mean)
            m2.copy_(new_m2)
            return total

        totals = tree_leaves(tree_map(fold, *self._stats(), rollout_extras))
        self.counter.copy_(totals[0])
        return self
