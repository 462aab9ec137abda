"""Profiling helpers. Port of ``nnx_ppo_tpu/utils/profiling.py`` (51
lines): :func:`trace` over ``torch.profiler`` where JAX's is over
``jax.profiler``, and :func:`span`, the training step's named ranges.
JAX's ``Throughput`` meter has no counterpart: ``train_ppo`` computes
``throughput/train_sps`` itself.

A JAX trace shows its jitted functions by name. The port marks its
training step with :func:`span` ranges at the layer boundaries:
``ppo_step``; ``unroll_env`` (the rollout) and inside it, once per env
step, ``rollout.env`` (``env.step`` through the auto-reset's selects;
inside it ``rollout.carry_reset``, the network carry's reset and select);
``ppo_update`` (the whole minibatch loop, the update phase inside JAX's
``ppo_step``) and inside it, once per minibatch, ``update.loss``
(replay, bootstrap, GAE, loss), ``update.backward`` and
``update.optimizer`` (clipping and Adam); ``distillation_step``, whose
minibatch loop has the same three ``update.*`` ranges; and, where a
network has them, ``net.mamba``, ``net.attention`` and ``net.mlp``
around each hybrid layer's mixer and MLP (``networks/hybrid.py``). They
exist only while a profiler runs.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

# Reentrant and stateless, so one instance serves every span.
_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is enabled on this thread; otherwise a shared no-op context,
    so that an unprofiled step pays no dispatcher call, allocation or
    launch for its ranges."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


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
