"""Streaming moments as ``(count, mean, M2)`` triples.

Port of ``nnx_ppo_tpu/ops/welford.py``: the batch moments use the
population M2 (sum of squared deviations, ``var = M2 / count``) and the
merge is the associative parallel-variance rule (Chan et al. 1979).
Under data parallelism the JAX package leaves the cross-shard merge to
GSPMD; here :func:`all_merge_moments` gathers every rank's triples in one
collective and merges them in rank order, so every rank holds the same
bits.
"""

from __future__ import annotations

from typing import Any, Optional

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


def gather_fields(fields: list[list[torch.Tensor]], mesh: Any) -> list[list[list[torch.Tensor]]]:
    """``fields[i]`` (a list of tensors) as every rank holds it, in rank
    order: ``out[i][r][j]``, from one all-gather of all of them packed."""
    flat = [t.reshape(-1).to(torch.float32) for group in fields for t in group]
    rows = mesh.all_gather(torch.cat(flat))
    out = []
    offset = 0
    for group in fields:
        per_rank: list[list[torch.Tensor]] = [[] for _ in range(mesh.world_size)]
        for t in group:
            n = t.numel()
            for r in range(mesh.world_size):
                per_rank[r].append(rows[r, offset:offset + n].view(t.shape).to(t.dtype))
            offset += n
        out.append(per_rank)
    return out


def all_merge_moments(triples: list[tuple], mesh: Optional[Any]) -> list[tuple]:
    """Each ``(count, mean, M2)`` triple merged with the same triple of
    every other rank, in rank order (rank 0's first), from one all-gather.
    Without a mesh the triples come back as they are; at world size 1
    they come back with the same values (the gather's copy)."""
    if mesh is None:
        return triples
    fields = [[torch.as_tensor(c, dtype=torch.float32, device=m.device), m, m2]
              for c, m, m2 in triples]
    merged = []
    for per_rank in gather_fields(fields, mesh):
        acc = tuple(per_rank[0])
        for other in per_rank[1:]:
            acc = merge_moments(acc, tuple(other))
        merged.append(acc)
    return merged


def spread_fields(x: torch.Tensor) -> list[torch.Tensor]:
    """One rank's share of :func:`all_mean_var_std`: ``x``'s ``numel``,
    ``mean()``, ``var(correction=0)`` and ``std(correction=0)``."""
    return [torch.tensor(float(x.numel()), device=x.device), x.mean(),
            x.var(correction=0), x.std(correction=0)]


def merge_spread_fields(per_rank: list[list[torch.Tensor]]) -> tuple:
    """``(mean, var, std)`` of the ranks' :func:`spread_fields` merged in
    rank order; with one rank its own three (bitwise the single-process
    values), else the std is the root of the merged var."""
    count, mean, var, std = per_rank[0]
    for n_b, mean_b, var_b, _ in per_rank[1:]:
        count, mean, m2 = merge_moments((count, mean, var * count), (n_b, mean_b, var_b * n_b))
        var = m2 / count
        std = torch.sqrt(var)
    return mean, var, std


def all_mean_var_std(xs: list[torch.Tensor], mesh: Optional[Any]) -> list[tuple]:
    """``(mean, var, std)`` (population) of each tensor's elements over
    every rank, from one all-gather (:func:`spread_fields` of each rank,
    :func:`merge_spread_fields`). Without a mesh, or with one rank, the
    tensor's own ``mean()``, ``var(correction=0)`` and
    ``std(correction=0)``, so the result equals the single-process one to
    the bit."""
    local = [spread_fields(x) for x in xs]
    per_tensor = [[f] for f in local] if mesh is None else gather_fields(local, mesh)
    return [merge_spread_fields(per_rank) for per_rank in per_tensor]
