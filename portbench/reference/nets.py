"""Plain functional network pieces of the reference: dense layers, the
tanh-squashed Normal sampler, the observation normalizer and the Adam
update, written from their definitions.

Parameters live in a flat dict ``{name: tensor}`` that the benchmark
makes from the seed; a network is a function of that dict. Nothing here
holds state.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import matmul

LOG_2 = math.log(2.0)
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def dense(params: dict, name: str, x: torch.Tensor, precision: str, relu: bool) -> torch.Tensor:
    """``x @ W + b`` (the kernel stored ``[in, out]``), then ReLU."""
    y = matmul(x, params[name + ".W"], precision) + params[name + ".b"]
    return torch.relu(y) if relu else y


def mlp(params: dict, name: str, n_layers: int, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``n_layers`` dense layers ``name.0 ... name.{n-1}``, ReLU between
    them and none after the last."""
    for i in range(n_layers):
        x = dense(params, f"{name}.{i}", x, precision, relu=i < n_layers - 1)
    return x


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` in the stable form ``max(x, 0) + log1p(e^-|x|)``."""
    return torch.relu(x) + torch.log1p(torch.exp(-torch.abs(x)))


def tanh_log_det(z: torch.Tensor) -> torch.Tensor:
    """``log |d tanh(z) / dz|`` = ``2 (log 2 - z - softplus(-2 z))``."""
    return 2.0 * (LOG_2 - z - softplus(-2.0 * z))


def tanh_normal(mean_and_std: torch.Tensor, min_std: float, entropy_weight: float,
                noise=None, extras=None):
    """The tanh-squashed Normal policy head. In the rollout ``noise`` is
    ``(action noise, entropy noise)``, unit normals; in the replay
    ``extras`` is the stored ``(raw action, entropy noise)``. Returns
    ``(action, log-likelihood, entropy cost, (raw action, entropy noise))``;
    the entropy is the one-sample estimate at the stored noise."""
    mean, raw_std = torch.chunk(mean_and_std, 2, dim=-1)
    std = softplus(raw_std) + min_std
    if extras is None:
        action_noise, entropy_noise = noise
        raw = (mean + std * action_noise).detach()
    else:
        raw, entropy_noise = extras
    log_prob = -0.5 * torch.square((raw - mean) / std) - (HALF_LOG_2PI + torch.log(std))
    log_prob = log_prob - tanh_log_det(raw)
    loglik = log_prob.sum(dim=-1)
    z = mean + std * entropy_noise
    entropy = (0.5 + HALF_LOG_2PI + torch.log(std) + tanh_log_det(z)).sum(dim=-1)
    return torch.tanh(raw), loglik, -entropy_weight * entropy, (raw, entropy_noise)


def normalize(stats: dict, x: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Standardize with running moments ``(count, mean, M2)``: the std is
    ``sqrt(max(M2 / count, epsilon))``, or 10 before any sample."""
    count = stats["count"]
    std = torch.sqrt(torch.clamp(stats["M2"] / torch.clamp(count, min=1.0), min=epsilon))
    std = torch.where(count > 0, std, torch.full_like(std, 10.0))
    return (x - stats["mean"]) / std


def fold_moments(stats: dict, history: torch.Tensor) -> dict:
    """The running moments with every sample of ``history[T, B, f]``
    added, by the parallel-variance rule (Chan et al.)."""
    n_b = history.shape[0] * history.shape[1]
    mean_b = history.mean(dim=(0, 1))
    m2_b = torch.square(history - mean_b).sum(dim=(0, 1))
    total = stats["count"] + n_b
    weight = n_b / torch.clamp(total, min=1.0)
    shift = mean_b - stats["mean"]
    return {
        "count": total,
        "mean": stats["mean"] + shift * weight,
        "M2": stats["M2"] + m2_b + torch.square(shift) * (stats["count"] * weight),
    }


def adam_step(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              count: int, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam update (Kingma and Ba), the ``count``-th (from 1):
    returns ``(param, m, v)``."""
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1**count)
    v_hat = v / (1.0 - b2**count)
    return param - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v
