"""Generalized Advantage Estimation. Port of ``nnx_ppo_tpu/ops/gae.py``.

Semantics (``gae.py:44-51``): the bootstrap value is zeroed where
``done``; the one-step advantage is zeroed where ``truncated``; the
accumulated tail passes through ``(1 - done) * gamma * lambda``; the
result carries no gradient.

* :func:`gae_scan` is the plain PyTorch version: a reverse loop over T.
* :func:`gae_cuda` launches the hand-written kernel
  ``nnx_ppo_tpu_torch/csrc/gae.cu`` (it replaces the Pallas kernel
  ``gae_pallas``), counting its launches in ``gae_cuda.launches``.
* :func:`gae` dispatches by the tensors' device: the plain version for
  CPU tensors, the kernel for CUDA tensors. There is no fallback: a
  CUDA tensor that the kernel cannot take raises.

``done`` and ``truncation`` may be bool or float; both are cast to
float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nnx_ppo_tpu_torch.ops import cuda_build


def gae_scan(
    rewards: torch.Tensor,
    values_excl_last: torch.Tensor,
    last_value: torch.Tensor,
    done: torch.Tensor,
    truncation: torch.Tensor,
    lambda_: float,
    gamma: float,
) -> torch.Tensor:
    """Reverse-time GAE. Shapes: rewards/values/done/truncation
    ``[T, B]``, last_value ``[B]`` -> advantages ``[T, B]``."""
    T = rewards.shape[0]
    with torch.no_grad():
        done = done.to(torch.float32)
        truncation = truncation.to(torch.float32)
        next_value = last_value.detach()
        next_advantage = torch.zeros_like(next_value)
        out = []
        for t in reversed(range(T)):
            old_value = values_excl_last[t].detach()
            bootstrap = torch.where(done[t] != 0, 0.0, next_value)
            advantage = rewards[t] + gamma * bootstrap - old_value
            advantage = torch.where(truncation[t] != 0, 0.0, advantage)
            next_advantage = advantage + (1.0 - done[t]) * gamma * lambda_ * next_advantage
            out.append(next_advantage)
            next_value = old_value
        return torch.stack(out[::-1])


@functools.cache
def _gae_forward():
    """The kernel's C entry point, built and loaded on first use."""
    fn = cuda_build.load("gae").gae_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gae_cuda(
    rewards: torch.Tensor,
    values_excl_last: torch.Tensor,
    last_value: torch.Tensor,
    done: torch.Tensor,
    truncation: torch.Tensor,
    lambda_: float,
    gamma: float,
) -> torch.Tensor:
    """GAE through the CUDA kernel, on the current stream."""
    if rewards.ndim != 2:
        raise ValueError(f"rewards must be [T, B], got {tuple(rewards.shape)}")
    T, B = rewards.shape
    device = rewards.device
    if device.type != "cuda":
        raise ValueError(f"gae_cuda takes CUDA tensors, got {device}")
    expected = {
        "values_excl_last": (values_excl_last, (T, B)),
        "last_value": (last_value, (B,)),
        "done": (done, (T, B)),
        "truncation": (truncation, (T, B)),
    }
    for name, (x, shape) in expected.items():
        if tuple(x.shape) != shape or x.device != device:
            raise ValueError(
                f"{name}: expected shape {shape} on {device}, got "
                f"{tuple(x.shape)} on {x.device}"
            )
    for name, x in (("rewards", rewards), ("values_excl_last", values_excl_last),
                    ("last_value", last_value)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if T >= 2**31 or B >= 2**31:
        raise ValueError(f"[T, B] = [{T}, {B}] is too large for the kernel")
    out = torch.empty((T, B), dtype=torch.float32, device=device)
    if T == 0 or B == 0:
        return out
    with torch.no_grad():
        ins = [
            rewards.detach().contiguous(),
            values_excl_last.detach().contiguous(),
            last_value.detach().contiguous(),
            done.detach().to(torch.float32).contiguous(),
            truncation.detach().to(torch.float32).contiguous(),
        ]
    stream = torch.cuda.current_stream(device)
    err = _gae_forward()(
        *(x.data_ptr() for x in ins), out.data_ptr(), T, B,
        float(gamma), float(lambda_), stream.device.index, stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError_t {err}")
    gae_cuda.launches += 1
    return out


gae_cuda.launches = 0


def gae(
    rewards: torch.Tensor,
    values_excl_last: torch.Tensor,
    last_value: torch.Tensor,
    done: torch.Tensor,
    truncation: torch.Tensor,
    lambda_: float,
    gamma: float,
) -> torch.Tensor:
    """GAE dispatched by device: :func:`gae_cuda` for CUDA tensors,
    :func:`gae_scan` for CPU tensors; any other device raises."""
    device = rewards.device
    if device.type == "cuda":
        return gae_cuda(rewards, values_excl_last, last_value, done, truncation, lambda_, gamma)
    if device.type == "cpu":
        return gae_scan(rewards, values_excl_last, last_value, done, truncation, lambda_, gamma)
    raise ValueError(f"gae has no implementation for device {device}")
