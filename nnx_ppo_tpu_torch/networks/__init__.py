"""Network modules. Port of ``nnx_ppo_tpu/networks``, with every public
name of it: feed-forward, recurrent, delay and variational layers,
containers and utilities, samplers, the normalizer, the PPO adapter and
the factories; and, with no JAX counterpart, the hybrid trunk of Mamba-2
and attention layers (``hybrid.py``). The population graph is in ``networks.graph``."""

from nnx_ppo_tpu_torch.networks.adapter import PPOAdapter
from nnx_ppo_tpu_torch.networks.containers import Concat, Parallel, Sequential, Splitter
from nnx_ppo_tpu_torch.networks.delay import Delay
from nnx_ppo_tpu_torch.networks.factories import (
    make_mlp,
    make_mlp_actor_critic,
    make_mlp_layers,
)
from nnx_ppo_tpu_torch.networks.feedforward import Dense
from nnx_ppo_tpu_torch.networks.hybrid import (
    GroupedQueryAttention,
    HybridBlock,
    HybridTrunk,
    Mamba2Mixer,
    RMSNorm,
    SwiGLU,
)
from nnx_ppo_tpu_torch.networks.normalizer import Normalizer
from nnx_ppo_tpu_torch.networks.recurrent import GRU, LSTM
from nnx_ppo_tpu_torch.networks.sampling_layers import ActionSampler, NormalTanhSampler
from nnx_ppo_tpu_torch.networks.types import (
    ModuleOutput,
    ModuleState,
    PPONetworkOutput,
    StatefulModule,
    StatefulModuleOutput,
)
from nnx_ppo_tpu_torch.networks.utils import Filter, Flattener, Map, Merge, Scale
from nnx_ppo_tpu_torch.networks.variational import (
    AR1VariationalBottleneck,
    VariationalBottleneck,
)

__all__ = [
    "AR1VariationalBottleneck",
    "ActionSampler",
    "Concat",
    "Delay",
    "Dense",
    "GRU",
    "GroupedQueryAttention",
    "HybridBlock",
    "HybridTrunk",
    "LSTM",
    "Mamba2Mixer",
    "RMSNorm",
    "SwiGLU",
    "VariationalBottleneck",
    "Filter",
    "Flattener",
    "Map",
    "Merge",
    "ModuleOutput",
    "ModuleState",
    "NormalTanhSampler",
    "Normalizer",
    "PPOAdapter",
    "PPONetworkOutput",
    "Parallel",
    "Scale",
    "Sequential",
    "Splitter",
    "StatefulModule",
    "StatefulModuleOutput",
    "make_mlp",
    "make_mlp_actor_critic",
    "make_mlp_layers",
]
