"""Variational bottleneck layers. Port of
``nnx_ppo_tpu/networks/variational.py:30-215``.

Both draw their reparameterization noise ``eps`` from the caller's
``generator`` (no generator and no extras: ``eps = 0``, z is the mean),
as every sampling module of the port does, where the JAX layers keep
per-env PRNG keys in their carries. ``eps`` is snapshotted into
``rollout_extras``, so the replay reproduces each z exactly with
gradients through the mean and the std.

The AR1 variant keeps ``last_z`` in its carry, with a NaN sentinel
written by ``reset_state``; ``where(isnan(prev_z), z, prev_z)`` before
the difference gives the penalty a zero value and a zero, finite
gradient on the first step after a reset (``variational.py:142-148``).
The select stands before the subtraction, so no NaN reaches the backward
pass through the unselected branch, with ``backprop_through_time`` on or
off.
"""

from __future__ import annotations

from typing import Optional

import torch

from nnx_ppo_tpu_torch.networks.sampling_layers import softplus
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule


def _draw_eps(mean: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        return torch.zeros_like(mean)
    return torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)


class VariationalBottleneck(StatefulModule):
    """Reparameterized normal sample from ``[B, 2 * latent]`` (mean |
    log std), with ``kl_weight * KL(q || N(0, 1))`` as regularization
    loss. Replay-time-static; the carry is empty."""

    def __init__(self, latent_size: int, kl_weight: float = 1.0, min_std: float = 1e-6):
        super().__init__()
        self.latent_size = latent_size
        self.kl_weight = kl_weight
        self.min_std = min_std

    @classmethod
    def create(
        cls, latent_size: int, kl_weight: float = 1.0, min_std: float = 1e-6
    ) -> "VariationalBottleneck":
        return cls(latent_size, kl_weight, min_std)

    def _sample(self, x: torch.Tensor, eps: Optional[torch.Tensor], generator):
        mean, log_std = torch.chunk(x, 2, dim=-1)
        std = softplus(log_std) + self.min_std
        if eps is None:
            eps = _draw_eps(mean, generator)
        z = mean + std * eps
        kl_per_dim = 0.5 * (torch.square(mean) + torch.square(std) - 2 * torch.log(std) - 1)
        return mean, std, z, kl_per_dim.sum(dim=-1), eps

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        mean, std, z, kl, eps = self._sample(x, rollout_extras, generator)
        return ModuleOutput(
            next_state=state,
            output=z,
            regularization_loss=self.kl_weight * kl,
            metrics={"mu": mean, "sigma": std, "kl_divergence": kl},
            rollout_extras=eps.detach(),
        )

    @property
    def replay_time_static(self) -> bool:
        return True


class AR1VariationalBottleneck(VariationalBottleneck):
    """Variational bottleneck plus the AR(1) smoothness penalty
    ``ar1_weight * mean((z - prev_z)^2)``. Carry ``{"last_z": [B,
    latent]}``, NaN after a reset."""

    def __init__(
        self,
        latent_size: int,
        kl_weight: float = 1.0,
        min_std: float = 1e-6,
        ar1_weight: float = 1.0,
        backprop_through_time: bool = True,
    ):
        super().__init__(latent_size, kl_weight, min_std)
        self.ar1_weight = ar1_weight
        self.backprop_through_time = backprop_through_time
        # Carries are made on the module's device.
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)

    @classmethod
    def create(
        cls,
        latent_size: int,
        kl_weight: float = 1.0,
        min_std: float = 1e-6,
        ar1_weight: float = 1.0,
        backprop_through_time: bool = True,
    ) -> "AR1VariationalBottleneck":
        return cls(latent_size, kl_weight, min_std, ar1_weight, backprop_through_time)

    def _ar1_penalty(self, z: torch.Tensor, prev_z: torch.Tensor) -> torch.Tensor:
        if not self.backprop_through_time:
            prev_z = prev_z.detach()
        safe_prev_z = torch.where(torch.isnan(prev_z), z, prev_z)
        return torch.mean(torch.square(z - safe_prev_z), dim=-1)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        mean, std, z, kl, eps = self._sample(x, rollout_extras, generator)
        l2_diff = self._ar1_penalty(z, state["last_z"])
        return ModuleOutput(
            next_state={"last_z": z},
            output=z,
            regularization_loss=self.kl_weight * kl + self.ar1_weight * l2_diff,
            metrics={"mu": mean, "sigma": std, "kl_divergence": kl, "l2_diff": l2_diff},
            rollout_extras=eps.detach(),
        )

    @property
    def replay_time_static(self) -> bool:
        return False

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """Vectorised replay (``variational.py:178-203``): with the stored
        noise every ``z_t`` is a batched function of ``(x_t, eps_t)``; the
        penalty needs only the z sequence shifted by one step with the
        sentinel put back where the step before was done."""
        _, _, z_seq, kl_seq, _ = self._sample(obs_seq, extras_seq, None)
        nan = torch.full_like(z_seq[0], float("nan"))
        prev_z = torch.cat([state["last_z"][None], z_seq[:-1]], dim=0)
        reset_before = torch.cat([torch.zeros_like(done_seq[:1]), done_seq[:-1]], dim=0).bool()
        prev_z = torch.where(reset_before[..., None], nan, prev_z)
        l2_seq = self._ar1_penalty(z_seq, prev_z)
        final_last_z = torch.where(done_seq[-1].bool()[..., None], nan, z_seq[-1])
        reg_seq = self.kl_weight * kl_seq + self.ar1_weight * l2_seq
        return z_seq, reg_seq, {"last_z": final_last_z}

    def initialize_state(self, batch_size: int) -> dict:
        return {"last_z": torch.full(
            (batch_size, self.latent_size), float("nan"), device=self._anchor.device
        )}

    def reset_state(self, prev_state: dict) -> dict:
        return {"last_z": torch.full_like(prev_state["last_z"], float("nan"))}
