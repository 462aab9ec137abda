"""Metrics. Port of ``nnx_ppo_tpu/algorithms/metrics.py``
(``compute_metrics`` :20, ``log_weight_stats`` :108). Metric names are
the JAX package's (``name/mean``, ``name/std``, ``name/pN``); every std
is the population std."""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Any, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.algorithms.types import LoggingLevel, Transition


def compute_metrics(
    loss_metrics: dict[str, Any],
    rollout_data: Transition,
    logging_level: LoggingLevel,
    percentile_levels: Optional[tuple[int, ...]] = None,
) -> dict[str, Any]:
    """Flag-gated metric dict of scalar tensors."""
    metrics: dict[str, Any] = {}
    for k, v in loss_metrics.items():
        _log_metric(metrics, k, v, percentile_levels)
    if LoggingLevel.TRAINING_ENV_METRICS in logging_level:
        for k, v in rollout_data.metrics.items():
            _log_metric(metrics, k, v, percentile_levels)
    if LoggingLevel.TRAIN_ROLLOUT_STATS in logging_level:
        _log_metric(metrics, "rollout_batch/reward", rollout_data.rewards, percentile_levels)
        _log_metric(
            metrics,
            "rollout_batch/action",
            rollout_data.network_output.actions,
            percentile_levels,
        )
        metrics["rollout_batch/done_rate"] = rollout_data.done.float().mean()
        metrics["rollout_batch/truncation_rate"] = rollout_data.truncated.float().mean()
    if LoggingLevel.ROLLOUT_OBS in logging_level:
        _log_metric(metrics, "rollout_batch/obs", rollout_data.obs, percentile_levels)
    if LoggingLevel.ACTOR_EXTRA in logging_level:
        _log_metric(
            metrics,
            "loglikelihood",
            rollout_data.network_output.loglikelihoods,
            percentile_levels,
        )
    if LoggingLevel.CRITIC_EXTRA in logging_level:
        _log_metric(
            metrics,
            "losses/predicted_value",
            rollout_data.network_output.value_estimates,
            percentile_levels,
        )
    return metrics


def _summarize(
    x: torch.Tensor, percentile_levels: Optional[tuple[int, ...]]
) -> dict[Optional[str], torch.Tensor]:
    """Reduce one tensor to named scalars: bool -> fraction true (no
    suffix); float -> percentiles if levels are given, else mean/std."""
    if x.dtype == torch.bool:
        return {None: x.float().mean()}
    if percentile_levels:
        q = torch.tensor(percentile_levels, dtype=x.dtype, device=x.device) / 100.0
        values = torch.quantile(x.flatten(), q)
        return {f"p{int(level)}": values[i] for i, level in enumerate(percentile_levels)}
    return {"mean": x.mean(), "std": x.std(correction=0)}


def _log_metric(
    metrics: dict[str, Any],
    name: str,
    x: Any,
    percentile_levels: Optional[tuple[int, ...]] = None,
) -> None:
    """Flatten a (possibly Mapping-nested) metric into scalar entries."""
    pending: list[tuple[str, Any]] = [(name, x)]
    while pending:
        prefix, value = pending.pop()
        if isinstance(value, Mapping):
            pending.extend((f"{prefix}/{k}", v) for k, v in value.items())
            continue
        for suffix, scalar in _summarize(value, percentile_levels).items():
            metrics[prefix if suffix is None else f"{prefix}/{suffix}"] = scalar


def log_weight_stats(
    metrics: dict[str, Any],
    networks: nn.Module,
    percentile_levels: Optional[tuple[int, ...]] = None,
) -> None:
    """Stats over all trainable parameters, as ``weights/...``."""
    flat = [p.detach().reshape(-1) for p in networks.parameters()]
    if not flat:
        warnings.warn("No trainable parameters found; weight stats skipped.")
        return
    _log_metric(metrics, "weights", torch.cat(flat), percentile_levels)
