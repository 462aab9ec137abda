"""Action samplers: the abstract ``ActionSampler`` and the tanh-squashed
Normal sampler.

Port of ``nnx_ppo_tpu/networks/sampling_layers.py`` (``ActionSampler``
:44, ``NormalTanhSampler`` :52-163):

* ``rollout_extras is None`` (ROLLOUT / INFERENCE): draw action and
  entropy noise from the caller's ``generator`` and snapshot
  ``raw_action`` and ``entropy_noise`` into the extras;
* ``rollout_extras`` given (LOSS_REPLAY): reuse the stored snapshot;
  no RNG is touched, so the module is replay-time-static.

std is ``(softplus(raw) + min_std) * std_scale``. ``softplus`` is
``jax.nn.softplus`` exactly (``logaddexp(x, 0)``), not
``torch.nn.functional.softplus``, which turns linear above 20. The
log-likelihood uses the stable tanh log-det
``2 (log 2 - z - softplus(-2 z))``. In eval mode (``module.eval()``,
the JAX ``deterministic`` flag) the action is the mean.

The carry is empty: draws come from the generator passed down by the
caller (see ``nnx_ppo_tpu_torch/networks/types.py``). With neither a
generator nor extras the noise is zero.
"""

from __future__ import annotations

import math

import torch

from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule

_LOG_2 = math.log(2.0)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, computed as ``jnp.logaddexp`` computes it."""
    return torch.relu(x) + torch.log1p(torch.exp(-torch.abs(x)))


def _tanh_log_det_jacobian(z: torch.Tensor) -> torch.Tensor:
    return 2.0 * (_LOG_2 - z - softplus(-2.0 * z))


class ActionSampler(StatefulModule):
    """Base class for samplers: consume distribution parameters, emit a
    ``{"action", "log_likelihood"}`` dict plus replay extras.

    ``deterministic`` (the JAX field) is the module's eval mode here:
    ``module.eval()`` makes a sampler emit the distribution's mean."""

    @property
    def deterministic(self) -> bool:
        return not self.training


class NormalTanhSampler(ActionSampler):
    """Input ``[..., 2 * action_dim]`` (mean | raw std); output
    ``{"action", "log_likelihood"}``; the entropy bonus enters as a
    negative regularization loss."""

    def __init__(
        self,
        entropy_weight: float = 1e-2,
        min_std: float = 1e-3,
        std_scale: float = 1.0,
    ):
        super().__init__()
        self.entropy_weight = entropy_weight
        self.min_std = min_std
        self.std_scale = std_scale

    @classmethod
    def create(
        cls,
        entropy_weight: float = 1e-2,
        min_std: float = 1e-3,
        std_scale: float = 1.0,
    ) -> "NormalTanhSampler":
        return cls(entropy_weight, min_std, std_scale)

    def forward(
        self, state, mean_and_std, rollout_extras=None, generator=None
    ) -> ModuleOutput:
        mean, raw_std = torch.chunk(mean_and_std, 2, dim=-1)
        std = (softplus(raw_std) + self.min_std) * self.std_scale

        if rollout_extras is None:
            if generator is None:
                noise = torch.zeros_like(mean)
                entropy_noise = torch.zeros_like(mean)
            else:
                noise = torch.randn(
                    mean.shape, generator=generator, device=mean.device, dtype=mean.dtype
                )
                entropy_noise = torch.randn(
                    mean.shape, generator=generator, device=mean.device, dtype=mean.dtype
                )
            sampled = mean if self.deterministic else mean + std * noise
            raw_action = sampled.detach()
        else:
            raw_action = rollout_extras["raw_action"]
            entropy_noise = rollout_extras["entropy_noise"]

        action = torch.tanh(raw_action)
        loglikelihood = self._loglikelihood(raw_action, mean, std)
        entropy_cost = -self.entropy_weight * self._entropy(mean, std, entropy_noise)
        return ModuleOutput(
            next_state=state,
            output={"action": action, "log_likelihood": loglikelihood},
            regularization_loss=entropy_cost,
            metrics={"mu": mean, "sigma": std},
            rollout_extras={
                "raw_action": raw_action,
                "entropy_noise": entropy_noise.detach(),
            },
        )

    @property
    def replay_time_static(self) -> bool:
        return True

    @staticmethod
    def _loglikelihood(
        raw_action: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
    ) -> torch.Tensor:
        z = raw_action
        log_unnormalized = -0.5 * torch.square((z - mean) / std)
        log_normalization = _HALF_LOG_2PI + torch.log(std)
        log_prob = log_unnormalized - log_normalization
        log_prob = log_prob - _tanh_log_det_jacobian(z)
        return log_prob.sum(dim=-1)

    @staticmethod
    def _entropy(
        mean: torch.Tensor, std: torch.Tensor, noise: torch.Tensor
    ) -> torch.Tensor:
        """Single-sample estimate of the tanh-Normal entropy with the
        stored noise, so the replay estimate equals the rollout's."""
        normal_entropy = 0.5 + _HALF_LOG_2PI + torch.log(std)
        z = mean + std * noise.detach()
        return (normal_entropy + _tanh_log_det_jacobian(z)).sum(dim=-1)
