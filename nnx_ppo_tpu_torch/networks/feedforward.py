"""Dense layer. Port of ``nnx_ppo_tpu/networks/feedforward.py``.

The kernel keeps the JAX layout ``[in, out]`` and the layer computes
``x @ kernel + bias`` (``feedforward.py:73``), so weights carry across
from the JAX package without a transpose (``nnx_ppo_tpu_torch/convert.py``).

``compute_dtype`` (``feedforward.py:68-78``; typically ``torch.bfloat16``
or ``"bfloat16"``): JAX computes ``jnp.dot(x.astype(bf16),
kernel.astype(bf16), preferred_element_type=f32)``, both operands rounded
to bf16, the products accumulated in float32, a float32 output. A matmul
of two bf16 tensors in PyTorch rounds its output to bf16 too, and this
PyTorch's ``out_dtype=torch.float32`` form has no CPU kernel, so the
layer computes the float32 product of the bf16-rounded operands: the
same function (each product of two bf16 values is exact in float32) on
the CPU and on the card. Its gradients pass through the same casts, so
they are rounded to bf16 at the operands as JAX's are. Parameters stay
float32. Without ``compute_dtype`` an input of another dtype (a bf16
replay store's observations) is promoted to the kernel's, as ``jnp.dot``
promotes it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

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


def as_dtype(dtype: Union[None, str, torch.dtype]) -> Optional[torch.dtype]:
    """``torch.bfloat16`` for ``"bfloat16"`` (the JAX suite's spelling)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32."""
    return x.to(dtype).to(torch.float32)


class Dense(StatefulModule):
    """Linear layer + optional activation. Stateless (empty carry)."""

    def __init__(
        self,
        kernel: torch.Tensor,
        bias: Optional[torch.Tensor],
        activation: Optional[Callable] = None,
        compute_dtype: Union[None, str, torch.dtype] = None,
    ):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.activation = activation
        self.compute_dtype = as_dtype(compute_dtype)

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
        compute_dtype: Union[None, str, torch.dtype] = None,
    ) -> "Dense":
        kernel = variance_scaling_uniform(
            (in_features, out_features), initializer_scale, generator
        )
        bias = torch.zeros(out_features) if use_bias else None
        return cls(kernel, bias, activation, compute_dtype)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        if self.compute_dtype is None:
            # jnp.dot promotes a bf16 input (a bf16 replay store) to the
            # kernel's float32, exactly; torch.matmul refuses mixed dtypes.
            y = torch.matmul(x if x.dtype == self.kernel.dtype else x.to(self.kernel.dtype),
                             self.kernel)
        else:
            y = torch.matmul(rounded(x, self.compute_dtype), rounded(self.kernel, self.compute_dtype))
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return ModuleOutput((), y, 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True
