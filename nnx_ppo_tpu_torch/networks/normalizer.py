"""Online (Welford) input normalizer.

Port of ``nnx_ppo_tpu/networks/normalizer.py``. The forward is read-only
on the running statistics and emits its raw input as ``rollout_extras``;
:meth:`update_statistics` folds the ``[T, B, f]`` history in once per
training step, after the gradient updates. Before the first fold the
standard deviation is 10.0; ``epsilon`` floors the variance, not the std
(``normalizer.py:60-69``). Statistics are float32 buffers (``mean``,
``M2``, ``counter``), so they move with ``.to(device)`` and are excluded
from ``parameters()``. Observations are a single tensor in this slice.
"""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule
from nnx_ppo_tpu_torch.ops.welford import batch_moments, merge_moments


class Normalizer(StatefulModule):
    """Standardizes ``x`` to zero mean / unit variance with running
    statistics."""

    def __init__(self, shape: int | tuple[int, ...], epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("M2", torch.zeros(shape))
        self.register_buffer("counter", torch.zeros(()))

    @classmethod
    def create(cls, shape: int | tuple[int, ...], epsilon: float = 1e-6) -> "Normalizer":
        return cls(shape, epsilon)

    def _std(self) -> torch.Tensor:
        count = torch.clamp(self.counter, min=1.0)
        std = torch.sqrt(torch.clamp(self.M2 / count, min=self.epsilon))
        return torch.where(self.counter > 0, std, 10.0)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        output = (x - self.mean) / self._std()
        return ModuleOutput((), output, 0.0, {}, rollout_extras=x)

    @property
    def replay_time_static(self) -> bool:
        return True

    @torch.no_grad()
    def update_statistics(self, rollout_extras: torch.Tensor) -> "Normalizer":
        """Fold the ``[T, B, *feat]`` history into the running stats."""
        total, mean, m2 = merge_moments(
            (self.counter, self.mean, self.M2),
            batch_moments(rollout_extras, n_batch_axes=2),
        )
        self.mean.copy_(mean)
        self.M2.copy_(m2)
        self.counter.copy_(total)
        return self
