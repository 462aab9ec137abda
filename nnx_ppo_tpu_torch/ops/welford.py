"""Streaming moments as ``(count, mean, M2)`` triples.

Port of ``nnx_ppo_tpu/ops/welford.py``: the batch moments use the
population M2 (sum of squared deviations, ``var = M2 / count``) and the
merge is the associative parallel-variance rule (Chan et al. 1979).
"""

from __future__ import annotations

import torch


def batch_moments(samples: torch.Tensor, n_batch_axes: int = 1) -> tuple:
    """Moments of ``samples`` along its ``n_batch_axes`` leading axes."""
    axes = tuple(range(n_batch_axes))
    count = 1
    for a in axes:
        count *= samples.shape[a]
    mean = samples.mean(dim=axes)
    m2 = torch.square(samples - mean).sum(dim=axes)
    return count, mean, m2


def merge_moments(a: tuple, b: tuple) -> tuple:
    """Associative merge of two ``(count, mean, M2)`` triples; safe when
    either side is empty (``count == 0``)."""
    n_a, mean_a, m2_a = a
    n_b, mean_b, m2_b = b
    total = n_a + n_b
    weight_b = n_b / (torch.clamp(total, min=1) if torch.is_tensor(total) else max(total, 1))
    shift = mean_b - mean_a
    mean = mean_a + shift * weight_b
    m2 = m2_a + m2_b + torch.square(shift) * (n_a * weight_b)
    return total, mean, m2
