"""Minibatch planning (port of ``nnx_ppo_tpu/parallel``, one device)."""

from nnx_ppo_tpu_torch.parallel.permutation import minibatch_permutations, minibatch_plan

__all__ = ["minibatch_permutations", "minibatch_plan"]
