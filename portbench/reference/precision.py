"""The precisions the reference computes its matrix products in.

A configuration states one compute precision; the reference computes in
it, and the control computes in the nearest precision below it, the step
that would tempt an optimisation:

* ``float32``: plain float32 products, TF32 off;
* ``tf32``: both operands rounded to TF32 (10 explicit mantissa bits,
  round to nearest even), products and sums in float32, which is what a
  TF32 tensor-core GEMM computes; the control of a float32 configuration;
* ``bfloat16``: both operands rounded to bf16, products and sums in
  float32 (the port's ``Dense(compute_dtype=bf16)``);
* ``fp8_e4m3``: both operands scaled per tensor to the e4m3 range
  (largest magnitude to 448), rounded to float8 e4m3 and scaled back;
  the control of a bf16 configuration.

The roundings are written out on float32 tensors, so they give the same
numbers on the CPU and on the card.

A precision followed by ``/split`` computes in that precision with each
product's sums in another order: the inner dimension in two halves,
their products added. It stands for a sound change of a GEMM's algorithm
and reads how far such a change moves the numbers compared.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDINGS = {
    "float32": None,
    "tf32": round_tf32,
    "bfloat16": round_bf16,
    "fp8_e4m3": round_fp8_e4m3,
}

# The control's precision for each stated precision.
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8_e4m3"}


class _RoundThrough(torch.autograd.Function):
    """Rounds in the forward pass; the gradient passes the rounding as
    the operand's cast does in a mixed-precision product (the gradient
    itself is rounded where it meets the next product)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in ``precision``, float32 out."""
    if precision.endswith("/split"):
        base, h = precision[: -len("/split")], w.shape[0] // 2
        return matmul(x[..., :h], w[:h], base) + matmul(x[..., h:], w[h:], base)
    fn = ROUNDINGS[precision]
    if fn is None:
        return torch.matmul(x, w)
    if precision == "bfloat16":
        # The cast itself, as the port's layer writes it, so that the
        # gradients meet the same roundings.
        return torch.matmul(round_bf16(x), round_bf16(w))
    return torch.matmul(_RoundThrough.apply(x, fn), _RoundThrough.apply(w, fn))
