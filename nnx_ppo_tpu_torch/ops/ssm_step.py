"""The step form of a Mamba-2 mixer's state update (Dao & Gu,
arXiv:2405.21060), as the hybrid trunk's rollout runs it once per Mamba
layer and control step (``networks/hybrid.py``).

Per env and head, with the head's state ``s [P, N]``::

    s' = exp(dt A) s + (dt x) outer B        y = s' C + D x

* :func:`ssm_step_plain` is the plain PyTorch version, the CPU path and
  the kernel's oracle;
* :func:`ssm_step_cuda` launches ``csrc/ssm_step.cu``, one launch for all
  envs and heads, which reads the state once and writes the new one once
  (it replaces no TPU kernel: the JAX package has no state-space layer);
* :func:`ssm_step` dispatches by the state's device, with no fallback: a
  CUDA tensor the kernel cannot take raises.

The new state is a new tensor, never the input's storage, so a carry kept
for the replay is never written. Every launch from the host counts one in
``ssm_step_cuda.launches`` and ``ssm_step_cuda.devices[card index]``; a
call while the stream is being captured into a CUDA graph launches
nothing and counts none, and whoever replays that graph counts its
launches (the hybrid trunk's rollout step: one per Mamba layer and
replay).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nnx_ppo_tpu_torch.ops import cuda_build


def ssm_step_plain(state, x, dt, A, B, C, D):
    """``state [E, H, P, N]``, ``x [E, H, P]``, ``dt [E, H]``, ``A`` and
    ``D [H]``, ``B`` and ``C [E, N]`` -> ``(new state, y [E, H, P])``."""
    dA = torch.exp(dt * A)
    new = dA[:, :, None, None] * state + (dt[:, :, None] * x)[..., None] * B[:, None, None, :]
    y = (new * C[:, None, None, :]).sum(-1) + D[:, None] * x
    return new, y


@functools.cache
def _ssm_step_forward():
    """The kernel's C entry point, built and loaded on first use."""
    fn = cuda_build.load("ssm_step").ssm_step_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_step_cuda(state, x, dt, A, B, C, D):
    """:func:`ssm_step_plain` through the CUDA kernel, on the current
    stream. Inputs are float32 on one card; non-contiguous ones are copied
    first."""
    E, H, P, N = state.shape
    device = state.device
    want = {"state": (E, H, P, N), "x": (E, H, P), "dt": (E, H), "A": (H,), "B": (E, N),
            "C": (E, N), "D": (H,)}
    args = {"state": state, "x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    for name, t in args.items():
        if tuple(t.shape) != want[name] or t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {want[name]} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if device.type != "cuda":
        raise ValueError(f"the SSM step kernel takes CUDA tensors, got {device}")
    if N % 32 != 0 or not 32 <= N <= 1024 or not 1 <= E <= 65535:
        raise ValueError(f"the SSM step kernel takes d_state a multiple of 32 up to 1024 and "
                         f"1 to 65535 envs, got d_state {N}, {E} envs")
    args = {k: t.contiguous() for k, t in args.items()}
    new = torch.empty_like(args["state"])
    y = torch.empty((E, H, P), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        err = _ssm_step_forward()(
            *(args[k].data_ptr() for k in ("state", "x", "dt", "A", "B", "C", "D")),
            new.data_ptr(), y.data_ptr(), E, H, P, N, device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_step kernel launch failed: cudaError_t {err}")
    if not torch.cuda.is_current_stream_capturing():
        cuda_build.count_launch(ssm_step_cuda, device)
    return new, y


cuda_build.counted(ssm_step_cuda)


def ssm_step(state, x, dt, A, B, C, D):
    """The step dispatched by device: the kernel for CUDA tensors, the
    plain version for CPU tensors; any other device raises. The kernel
    has no backward: on the card a step that needs gradients raises (the
    replay's gradients come from the chunked SSD, ``networks/hybrid.py``)."""
    device = state.device
    if device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (state, x, dt, A, B, C, D)):
            raise RuntimeError("the SSM step kernel has no backward; replay with the fused "
                               "(chunked) replay or take the step under torch.no_grad()")
        return ssm_step_cuda(state, x, dt, A, B, C, D)
    if device.type == "cpu":
        return ssm_step_plain(state, x, dt, A, B, C, D)
    raise ValueError(f"ssm_step has no implementation for device {device}")
