"""Connection edge spec for :class:`PopulationGraph`. Port of
``nnx_ppo_tpu/networks/graph/connection.py``: the (src, dst, delay)
routing; the edge's ``transform`` module lives in the graph's
``transforms``, at the edge's position."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Connection:
    """Edge spec: source and destination population names and an integer
    step delay (0 = the same step, made valid by the topological order)."""

    src: str
    dst: str
    delay: int

    def __post_init__(self):
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
