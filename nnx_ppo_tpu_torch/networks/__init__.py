"""Network modules (port of ``nnx_ppo_tpu/networks``: feed-forward
layers, containers, sampler, normalizer, PPO adapter, factories)."""

from nnx_ppo_tpu_torch.networks.adapter import PPOAdapter
from nnx_ppo_tpu_torch.networks.containers import Concat, Parallel, Sequential
from nnx_ppo_tpu_torch.networks.factories import (
    make_mlp,
    make_mlp_actor_critic,
    make_mlp_layers,
)
from nnx_ppo_tpu_torch.networks.feedforward import Dense
from nnx_ppo_tpu_torch.networks.normalizer import Normalizer
from nnx_ppo_tpu_torch.networks.sampling_layers import NormalTanhSampler
from nnx_ppo_tpu_torch.networks.types import (
    ModuleOutput,
    PPONetworkOutput,
    StatefulModule,
)

__all__ = [
    "Concat",
    "Dense",
    "ModuleOutput",
    "Normalizer",
    "NormalTanhSampler",
    "PPOAdapter",
    "Parallel",
    "PPONetworkOutput",
    "Sequential",
    "StatefulModule",
    "make_mlp",
    "make_mlp_actor_critic",
    "make_mlp_layers",
]
