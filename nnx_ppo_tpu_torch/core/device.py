"""Device selection for the port's entry points, and the envs' constants
on the device.

No JAX counterpart: the JAX package takes its device from the backend.
Here every entry point takes ``device=`` (default ``"cuda"``), and asking
for a device that is not present raises instead of carrying on quietly
on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, or ``RuntimeError`` when it is a CUDA
    device and no GPU is present. Once CUDA is initialized, a bare
    ``"cuda"`` is given the index of the current card (the rank's, under
    a mesh), so that it compares equal to the tensors made on it; before,
    it stays bare, and reading the index would initialize CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is "
            "present; pass device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceConstants:
    """Mixin of the batched envs: ``self._on(device, name)`` is the constant
    tensor ``self.<name>`` on ``device``, copied there once (a copy per
    step would stall the stream)."""

    def _on(self, device: torch.device, name: str) -> torch.Tensor:
        cache = self.__dict__.setdefault("_device_constants", {})
        key = (str(device), name)
        if key not in cache:
            cache[key] = getattr(self, name).to(device)
        return cache[key]
