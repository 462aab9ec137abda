"""nnx_ppo_tpu_torch: the PyTorch / CUDA port of ``nnx_ppo_tpu`` for one
NVIDIA H100.

It mirrors the JAX package's layout module for module and imports
nothing of it (nor JAX). Entry points run on ``device="cuda"`` unless the
caller asks for the CPU. Every Pallas kernel on a ported path is a
kernel written by hand for Hopper under ``csrc/``, built with ``nvcc``
at first use.
"""

__version__ = "0.1.0"

from nnx_ppo_tpu_torch import algorithms, core, envs, networks, ops, parallel, utils, wrappers

__all__ = [
    "algorithms",
    "core",
    "envs",
    "networks",
    "ops",
    "parallel",
    "utils",
    "wrappers",
]
