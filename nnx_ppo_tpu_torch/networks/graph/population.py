"""Population node spec for :class:`PopulationGraph`. Port of
``nnx_ppo_tpu/networks/graph/population.py``; populations hold no
parameters (those live in the connection transforms)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Population:
    """Node spec: declared size, optional transfer function, observation
    routing (``input_from``) and output exposure (``output_to``), plus the
    largest outgoing delay (which sizes the shared ring buffer of its
    outputs)."""

    name: str
    size: int
    activation: Optional[Callable]
    input_from: Optional[str]
    output_to: Optional[str]
    max_outgoing_delay: int = 0
