"""Metrics. Port of ``nnx_ppo_tpu/algorithms/metrics.py``
(``compute_metrics`` :20, ``log_weight_stats`` :108). Metric names are
the JAX package's (``name/mean``, ``name/std``, ``name/pN``); every std
is the population std.

Under a data-parallel mesh (``parallel/mesh.py``) every metric is the
global one and every rank logs the same numbers, as when GSPMD reduces
the sharded env axis: each update's loss metrics are averaged over the
ranks (their minibatch blocks are of equal size), and each sampled
tensor's mean and std merge the ranks' moments, all from one all-gather;
percentiles gather the tensor itself from every rank.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Any, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.algorithms.types import LoggingLevel, Transition
from nnx_ppo_tpu_torch.ops.welford import gather_fields, merge_spread_fields, spread_fields


def compute_metrics(
    loss_metrics: dict[str, Any],
    rollout_data: Transition,
    logging_level: LoggingLevel,
    percentile_levels: Optional[tuple[int, ...]] = None,
    mesh: Optional[Any] = None,
) -> dict[str, Any]:
    """Flag-gated metric dict of scalar tensors."""
    samples: list[tuple[str, torch.Tensor]] = []
    if LoggingLevel.TRAINING_ENV_METRICS in logging_level:
        for k, v in rollout_data.metrics.items():
            samples += _flatten(k, v)
    if LoggingLevel.TRAIN_ROLLOUT_STATS in logging_level:
        samples += _flatten("rollout_batch/reward", rollout_data.rewards)
        samples += _flatten("rollout_batch/action", rollout_data.network_output.actions)
        samples.append(("rollout_batch/done_rate", rollout_data.done != 0))
        samples.append(("rollout_batch/truncation_rate", rollout_data.truncated != 0))
    if LoggingLevel.ROLLOUT_OBS in logging_level:
        samples += _flatten("rollout_batch/obs", rollout_data.obs)
    if LoggingLevel.ACTOR_EXTRA in logging_level:
        samples += _flatten("loglikelihood", rollout_data.network_output.loglikelihoods)
    if LoggingLevel.CRITIC_EXTRA in logging_level:
        samples += _flatten("losses/predicted_value", rollout_data.network_output.value_estimates)
    return summarize_metrics(loss_metrics, samples, percentile_levels, mesh)


def summarize_metrics(
    loss_metrics: dict[str, Any],
    samples: list[tuple[str, torch.Tensor]],
    percentile_levels: Optional[tuple[int, ...]] = None,
    mesh: Optional[Any] = None,
) -> dict[str, Any]:
    """The metric dict of ``loss_metrics`` (each leaf stacked over the
    updates: ``[E·M]`` scalars, or ``[E·M, ...]`` samples) and then the
    named sampled tensors ``samples``, each reduced to named scalars as
    :func:`_summarize` says. With a ``mesh``, over every rank."""
    entries = [(name, x) for k, v in loss_metrics.items() for name, x in _flatten(k, v)]
    per_update = {name for name, x in entries if x.ndim == 1}
    entries += samples
    if mesh is not None:
        entries = _global(entries, per_update, percentile_levels, mesh)
    metrics: dict[str, Any] = {}
    for name, x in entries:
        for suffix, scalar in _summarize(x, percentile_levels).items():
            metrics[name if suffix is None else f"{name}/{suffix}"] = scalar
    return metrics


class _Moments:
    """A sampled tensor already reduced over every rank: its ``mean``,
    and its ``std`` unless it is a fraction of bools (``std`` None)."""

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor]):
        self.mean, self.std = mean, std


def _global(entries, per_update, percentile_levels, mesh):
    """``entries`` reduced over every rank, from one all-gather: the
    per-update vectors averaged over the ranks in rank order, and each
    sampled tensor's moments merged (bools: the fraction); with
    percentiles, each float sample tensor is gathered whole instead."""
    def kind(name, x):
        if name in per_update:
            return "update"
        return "moments" if x.dtype == torch.bool or not percentile_levels else "values"

    kinds = [kind(name, x) for name, x in entries]
    fields = [[x] if k == "update" else spread_fields(x.float() if x.dtype == torch.bool else x)
              for (_, x), k in zip(entries, kinds) if k != "values"]
    gathered = iter(gather_fields(fields, mesh)) if fields else iter(())
    out = []
    for (name, x), k in zip(entries, kinds):
        if k == "values":
            out.append((name, mesh.all_gather(x.reshape(-1)).reshape(-1)))
            continue
        per_rank = next(gathered)
        if k == "update":
            total = per_rank[0][0]
            for other in per_rank[1:]:
                total = total + other[0]
            out.append((name, total / mesh.world_size))
        else:
            mean, _, std = merge_spread_fields(per_rank)
            out.append((name, _Moments(mean, None if x.dtype == torch.bool else std)))
    return out


def _flatten(name: str, x: Any) -> list[tuple[str, torch.Tensor]]:
    """A (possibly Mapping-nested) metric as named tensors."""
    out: list[tuple[str, torch.Tensor]] = []
    pending: list[tuple[str, Any]] = [(name, x)]
    while pending:
        prefix, value = pending.pop()
        if isinstance(value, Mapping):
            pending.extend((f"{prefix}/{k}", v) for k, v in value.items())
        else:
            out.append((prefix, value))
    return out


def _summarize(
    x: torch.Tensor, percentile_levels: Optional[tuple[int, ...]]
) -> dict[Optional[str], torch.Tensor]:
    """Reduce one tensor to named scalars: bool -> fraction true (no
    suffix); float -> percentiles if levels are given, else mean/std."""
    if isinstance(x, _Moments):
        return {None: x.mean} if x.std is None else {"mean": x.mean, "std": x.std}
    if x.dtype == torch.bool:
        return {None: x.float().mean()}
    if percentile_levels:
        q = torch.tensor(percentile_levels, dtype=x.dtype, device=x.device) / 100.0
        values = torch.quantile(x.flatten(), q)
        return {f"p{int(level)}": values[i] for i, level in enumerate(percentile_levels)}
    return {"mean": x.mean(), "std": x.std(correction=0)}


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
    metrics.update(summarize_metrics({}, [("weights", torch.cat(flat))], percentile_levels))
