"""Numeric ops and the hand-written CUDA kernels' wrappers (port of
``nnx_ppo_tpu/ops``). JAX's ``gae_pallas`` is ``gae.gae_per_key`` /
``gae.gae_cuda`` here (the CUDA kernel ``csrc/gae.cu``)."""

from nnx_ppo_tpu_torch.ops.gae import gae, gae_scan
from nnx_ppo_tpu_torch.ops.linalg import cholesky_solve_small
from nnx_ppo_tpu_torch.ops.welford import batch_moments, merge_moments

__all__ = [
    "gae",
    "gae_scan",
    "cholesky_solve_small",
    "batch_moments",
    "merge_moments",
]
