"""Dense layer. Port of ``nnx_ppo_tpu/networks/feedforward.py``.

The kernel keeps the JAX layout ``[in, out]`` and the layer computes
``x @ kernel + bias`` (``feedforward.py:73``), so weights carry across
from the JAX package without a transpose (``nnx_ppo_tpu_torch/convert.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule


def variance_scaling_uniform(
    shape: tuple[int, int], scale: float, generator: torch.Generator
) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling(scale, "fan_in",
    "uniform")`` for an ``[in, out]`` kernel: U(-l, l), l = sqrt(3 scale / in)."""
    limit = math.sqrt(3.0 * scale / shape[0])
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


class Dense(StatefulModule):
    """Linear layer + optional activation. Stateless (empty carry)."""

    def __init__(
        self,
        kernel: torch.Tensor,
        bias: Optional[torch.Tensor],
        activation: Optional[Callable] = None,
    ):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.activation = activation

    @classmethod
    def create(
        cls,
        in_features: int,
        out_features: int,
        generator: torch.Generator,
        activation: Optional[Callable] = None,
        *,
        use_bias: bool = True,
        initializer_scale: float = 1.0,
    ) -> "Dense":
        kernel = variance_scaling_uniform(
            (in_features, out_features), initializer_scale, generator
        )
        bias = torch.zeros(out_features) if use_bias else None
        return cls(kernel, bias, activation)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        y = torch.matmul(x, self.kernel)
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return ModuleOutput((), y, 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True
