"""Data parallelism and minibatch planning (port of
``nnx_ppo_tpu/parallel``): the mesh over ``torch.distributed`` ranks and
shard-local minibatch permutations."""

from nnx_ppo_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharded,
    constrain_batch,
    constrain_time_batch,
    distributed_initialize,
    global_device_put,
    make_mesh,
    replicated,
    shard_training_state,
    training_state_shardings,
)
from nnx_ppo_tpu_torch.parallel.permutation import minibatch_permutations, minibatch_plan

__all__ = [
    "DATA_AXIS",
    "batch_sharded",
    "constrain_batch",
    "constrain_time_batch",
    "distributed_initialize",
    "global_device_put",
    "make_mesh",
    "minibatch_permutations",
    "minibatch_plan",
    "replicated",
    "shard_training_state",
    "training_state_shardings",
]
