"""Profiling helpers. Port of ``nnx_ppo_tpu/utils/profiling.py`` (51
lines): :func:`trace` over ``torch.profiler`` where JAX's is over
``jax.profiler``, and the :class:`Throughput` meter.

A JAX trace shows its jitted functions by name. The port's counterpart
is one ``torch.profiler.record_function`` range at the entry of each of
``ppo_step``, ``unroll_env``, ``ppo_update`` (the whole minibatch loop,
the update phase inside JAX's ``ppo_step``) and ``distillation_step``,
named after its function, so a trace splits a training step into its
rollout and its update.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from nnx_ppo_tpu_torch.core.struct import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    as a Chrome trace (``*.pt.trace.json``, for Perfetto or
    ``chrome://tracing``; TensorBoard need not be installed): CPU and
    CUDA activity where a card is present, CPU only otherwise. Wrap a
    handful of steady-state train steps::

        with profiling.trace("/tmp/ppo-trace"):
            for _ in range(5):
                state, _ = ppo_step(env, state, config, optimizer)
            torch.cuda.synchronize()

    Yields the profiler, whose ``key_averages()`` sum the ranges and
    kernels by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _synchronize(barrier: Any) -> None:
    """Wait for the devices of ``barrier``'s CUDA tensors (a tensor or a
    tree of tensors)."""
    for device in {x.device for x in tree_leaves(barrier) if torch.is_tensor(x) and x.is_cuda}:
        torch.cuda.synchronize(device)


class Throughput:
    """Steady-state env-steps/s meter with synchronize barriers (the
    reference's ``throughput/train_sps`` methodology)."""

    def __init__(self, steps_per_iter: int):
        self.steps_per_iter = steps_per_iter
        self._t0: Optional[float] = None
        self._iters = 0

    def start(self, barrier: Any = None) -> None:
        if barrier is not None:
            _synchronize(barrier)
        self._t0 = time.perf_counter()
        self._iters = 0

    def tick(self) -> None:
        self._iters += 1

    def stop(self, barrier: Any) -> float:
        _synchronize(barrier)
        elapsed = time.perf_counter() - self._t0
        return self.steps_per_iter * self._iters / elapsed
