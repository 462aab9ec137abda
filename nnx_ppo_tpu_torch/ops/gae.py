"""Generalized Advantage Estimation. Port of ``nnx_ppo_tpu/ops/gae.py``.

Semantics (``gae.py:44-51``): the bootstrap value is zeroed where
``done``; the one-step advantage is zeroed where ``truncated``; the
accumulated tail passes through ``(1 - done) * gamma * lambda``; the
result carries no gradient.

* :func:`gae_scan` is the plain PyTorch version: a reverse loop over T.
* :func:`gae_cuda` launches the hand-written kernel
  ``nnx_ppo_tpu_torch/csrc/gae.cu`` (it replaces the Pallas kernel
  ``gae_pallas``) for one reward key.
* :func:`gae_per_key` takes every reward key of a minibatch (the trees
  ``ppo_loss`` holds) and, on CUDA tensors, computes them all in ONE
  launch of the same kernel; on CPU tensors it is ``gae_scan`` per key.
* :func:`gae` dispatches one key by the tensors' device: the plain
  version for CPU tensors, the kernel for CUDA tensors.

Every launch of the kernel, from either entry, counts one in
``gae_cuda.launches``. There is no fallback: a CUDA tensor that the
kernel cannot take raises.

The plain version casts ``done`` and ``truncation`` to float32; the
kernel reads them as they come, bool or float32 (other dtypes raise), so
no cast runs on the card. A CUDA input is used in place when its columns
are contiguous, at any row stride (a column slice of a wider tensor
too); only an input whose columns are strided is copied first.
"""

from __future__ import annotations

import array
import ctypes
import functools
from typing import Any

import torch

from nnx_ppo_tpu_torch.core.struct import tree_map
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


# Reward keys one launch takes (gae.cu's kMaxKeys) and threads (env
# columns) per block.
MAX_KEYS = 8
GAE_COLUMNS = 32


@functools.cache
def _gae_forward():
    """The kernel's C entry point, built and loaded on first use."""
    fn = cuda_build.load("gae").gae_forward
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_int
    ] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows(x: torch.Tensor, B: int) -> tuple[torch.Tensor, int]:
    """``(x, row stride)``: ``x`` itself when its columns are contiguous
    (at any row stride, as in a column slice of a wider tensor), else a
    contiguous copy."""
    if x.is_contiguous():
        return x, B
    if x.stride(1) != 1:
        x = x.contiguous()
        return x, B
    return x, x.stride(0)


def _refuse(keys: list, T: int, B: int, device, flag_dtypes) -> None:
    """Raise for the first input of ``keys`` that the kernel cannot take."""
    names = ("rewards", "values", "last_value", "done", "truncation")
    dtypes = (torch.float32, torch.float32, torch.float32) + tuple(flag_dtypes)
    for key in keys:
        for name, x, dtype in zip(names, key, dtypes):
            shape = (B,) if name == "last_value" else (T, B)
            if x.shape != shape or x.device != device:
                raise ValueError(f"{name}: expected shape {shape} on {device}, got "
                                 f"{tuple(x.shape)} on {x.device}")
            if x.dtype != dtype:
                raise TypeError(f"{name}: expected {dtype} (as every key's), got {x.dtype}")


def _launch(keys: list, lambda_: float, gamma: float, tile_rows: int = 0) -> tuple:
    """One launch of the GAE kernel for every key of ``keys``, a list of
    ``(rewards, values, last_value, done, truncation)``: ``[T, B]`` float32
    rewards and values, ``[B]`` float32 last values, ``[T, B]`` bool or
    float32 flags (one dtype each across the keys). Returns the advantages
    per key and counts the launch in ``gae_cuda.launches``."""
    n = len(keys)
    if not 1 <= n <= MAX_KEYS:
        raise ValueError(f"the GAE kernel takes 1 to {MAX_KEYS} reward keys in one launch, got {n}")
    first = keys[0][0]
    if first.ndim != 2:
        raise ValueError(f"rewards must be [T, B], got {tuple(first.shape)}")
    T, B = shape = first.shape
    device = first.device
    if device.type != "cuda":
        raise ValueError(f"the GAE kernel takes CUDA tensors, got {device}")
    if T >= 2**31 or B >= 2**31:
        raise ValueError(f"[T, B] = [{T}, {B}] is too large for the kernel")
    f32 = torch.float32
    done_dtype, trunc_dtype = keys[0][3].dtype, keys[0][4].dtype
    for dtype in (done_dtype, trunc_dtype):
        if dtype != torch.bool and dtype != f32:
            raise TypeError(f"done and truncation must be bool or float32, got {dtype}")
    for r, v, last, d, tr in keys:
        if not (r.shape == v.shape == d.shape == tr.shape == shape and last.shape == (B,)
                and r.device == v.device == last.device == d.device == tr.device == device
                and r.dtype == v.dtype == last.dtype == f32 and d.dtype == done_dtype
                and tr.dtype == trunc_dtype):
            _refuse(keys, T, B, device, (done_dtype, trunc_dtype))
    outs = (torch.empty((n, T, B), dtype=f32, device=device).unbind(0) if n > 1
            else (torch.empty((T, B), dtype=f32, device=device),))
    if T == 0 or B == 0:
        return outs
    packed = array.array("q")
    inputs = []  # every tensor the kernel reads, alive until the launch
    for k, (r, v, last, d, tr) in enumerate(keys):
        (r, ld_r), (v, ld_v), (d, ld_d), (tr, ld_t) = (_rows(x, B) for x in (r, v, d, tr))
        last = last.contiguous()
        inputs.append((r, v, last, d, tr))
        packed.extend((r.data_ptr(), v.data_ptr(), last.data_ptr(), d.data_ptr(), tr.data_ptr(),
                       outs[k].data_ptr(), ld_r, ld_v, ld_d, ld_t))
    stream = torch.cuda.current_stream(device)
    err = _gae_forward()(
        packed.buffer_info()[0], n, T, B, gamma, lambda_, done_dtype == torch.bool,
        trunc_dtype == torch.bool, GAE_COLUMNS, tile_rows, device.index, stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError_t {err}")
    gae_cuda.launches += 1
    return outs


def gae_cuda(
    rewards: torch.Tensor,
    values_excl_last: torch.Tensor,
    last_value: torch.Tensor,
    done: torch.Tensor,
    truncation: torch.Tensor,
    lambda_: float,
    gamma: float,
) -> torch.Tensor:
    """GAE of one reward key through the CUDA kernel, on the current
    stream."""
    return _launch([(rewards, values_excl_last, last_value, done, truncation)], lambda_,
                   gamma)[0]


gae_cuda.launches = 0


def gae_per_key(
    rewards: Any,
    values_excl_last: Any,
    last_values: Any,
    done: Any,
    truncation: Any,
    lambda_: float,
    gamma: float,
) -> Any:
    """GAE of every reward key: ``rewards``, ``values_excl_last`` and
    ``last_values`` are trees of the same structure (a dict per reward key,
    or one tensor), ``done`` and ``truncation`` either one tensor shared by
    every key or trees of that structure. Returns the advantages in the
    structure of ``rewards``. CUDA tensors take ONE kernel launch for all
    keys (at most :data:`MAX_KEYS`); CPU tensors the plain version per key,
    ``tree_map(gae_scan, ...)``; any other device raises."""
    if torch.is_tensor(rewards):
        keys = [(rewards, values_excl_last, last_values, done, truncation)]
    elif isinstance(rewards, dict) and torch.is_tensor(done) and torch.is_tensor(truncation):
        # The trees ppo_loss holds: a dict per reward key, shared flags.
        keys = [(rewards[k], values_excl_last[k], last_values[k], done, truncation)
                for k in rewards]
    else:
        flags = [tree_map(lambda _: x, rewards) if torch.is_tensor(x) else x
                 for x in (done, truncation)]
        keys = []
        tree_map(lambda *key: keys.append(key), rewards, values_excl_last, last_values, *flags)
    device = keys[0][0].device if keys else torch.device("cpu")
    if device.type == "cuda":
        outs = _launch(keys, lambda_, gamma)
    elif device.type == "cpu":
        outs = [gae_scan(*key, lambda_, gamma) for key in keys]
    else:
        raise ValueError(f"gae has no implementation for device {device}")
    if torch.is_tensor(rewards):
        return outs[0]
    if isinstance(rewards, dict):
        return dict(zip(rewards, outs))
    it = iter(outs)
    return tree_map(lambda _: next(it), rewards)


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
