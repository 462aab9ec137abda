"""Numeric ops and the hand-written CUDA kernels' wrappers (port of
``nnx_ppo_tpu/ops``)."""
