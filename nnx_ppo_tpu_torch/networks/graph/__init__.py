"""Population graphs (port of ``nnx_ppo_tpu/networks/graph``)."""

from nnx_ppo_tpu_torch.networks.graph.connection import Connection
from nnx_ppo_tpu_torch.networks.graph.graph import (
    PopulationGraph,
    PopulationGraphBuilder,
)
from nnx_ppo_tpu_torch.networks.graph.population import Population

__all__ = [
    "Connection",
    "Population",
    "PopulationGraph",
    "PopulationGraphBuilder",
]
