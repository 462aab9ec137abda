"""The StatefulModule protocol: the network/algorithm contract.

Port of ``nnx_ppo_tpu/networks/types.py``. Two kinds of state, as there:

1. *module state*: parameters (``nn.Parameter``) and running statistics
   (registered buffers). Never written by the forward pass; statistics
   are folded in once per train step by :meth:`update_statistics`,
   which here updates the buffers in place and returns the module.
2. *carry state*: an explicit per-env tree threaded by the algorithm and
   reset at episode boundaries (empty for every module of this slice).

``rollout_extras`` is the ROLLOUT -> LOSS_REPLAY channel: ``None`` means
ROLLOUT/INFERENCE (sample fresh, emit the snapshot); anything else means
LOSS_REPLAY (consume the stored snapshot).

RNG (a deliberate departure from the JAX package)
--------------------------------------------------
The JAX package keeps one PRNG key per env in the carry and splits it on
every forward. Here carries hold no keys: the caller passes ONE explicit
``torch.Generator`` (on the tensors' device) down through ``generator=``
and a sampling module draws its ``[B, ...]`` noise from it. This is safe
for the loss because every draw is snapshotted into ``rollout_extras``
and the replay consumes only the snapshot, so the replay needs no
generator and stays a pure function of (params, obs, stored extras). A
forward with neither extras nor a generator draws nothing (samplers act
on zero noise); the loss uses that for the T+1 bootstrap forward, whose
actions are discarded, so the bootstrap never moves a later draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

ModuleState = Any  # (), dict, tuple, ... of per-env tensors


@dataclasses.dataclass
class PPONetworkOutput:
    """PPO-specific forward output, produced by ``PPOAdapter``."""

    actions: Any
    loglikelihoods: Any
    value_estimates: Any


@dataclasses.dataclass
class ModuleOutput:
    """Result of one module forward step (same five channels as the JAX
    ``ModuleOutput``). ``regularization_loss`` is a float or a tensor
    that broadcasts against the batch dims."""

    next_state: ModuleState
    output: Any
    regularization_loss: Any
    metrics: dict
    rollout_extras: Any = None


class StatefulModule(nn.Module):
    """Base class for network modules.

    ``forward(state, x, rollout_extras=None, generator=None)`` runs one
    batched step; the leading dims of ``x`` are batch dims (``[B]`` in
    the rollout, ``[T, B]`` in the fused replay).
    """

    def forward(
        self,
        state: ModuleState,
        x: Any,
        rollout_extras: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> ModuleOutput:
        raise NotImplementedError

    def initialize_state(self, batch_size: int) -> ModuleState:
        """Fresh per-env carry with leading dim ``batch_size``."""
        del batch_size
        return ()

    def reset_state(self, prev_state: ModuleState) -> ModuleState:
        """Carry after an episode reset."""
        return prev_state

    def update_statistics(self, rollout_extras: Any) -> "StatefulModule":
        """Fold a rollout's ``[T, B, ...]`` snapshots into running
        statistics, in place. Default: no statistics."""
        del rollout_extras
        return self

    @property
    def replay_time_static(self) -> bool:
        """True iff, given stored extras, this module's output and
        regularization loss depend only on (params, input, extras) and
        not on carry values (see the JAX docstring at
        ``nnx_ppo_tpu/networks/types.py:183``)."""
        return False

    def replay_sequence(
        self,
        state: ModuleState,
        obs_seq: Any,
        done_seq: torch.Tensor,
        extras_seq: Any,
    ) -> tuple[Any, Any, ModuleState]:
        """Replay over a whole ``[T, B, ...]`` stored sequence.

        Returns ``(output_seq, reg_seq, final_state)``. A
        replay-time-static module runs ONE forward over the ``[T, B]``
        leading dims; its carry is constant, so ``final_state`` is the
        carry it was given. The sequential replay of recurrent modules
        waits for the later slice that ports them.
        """
        del done_seq
        if not self.replay_time_static:
            raise NotImplementedError(
                f"{type(self).__name__} is not replay-time-static; the "
                "sequential replay has not been ported yet"
            )
        out = self(state, obs_seq, extras_seq)
        return out.output, out.regularization_loss, state
