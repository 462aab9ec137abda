"""The StatefulModule protocol: the network/algorithm contract.

Port of ``nnx_ppo_tpu/networks/types.py``. Two kinds of state, as there:

1. *module state*: parameters (``nn.Parameter``) and running statistics
   (registered buffers). Never written by the forward pass; statistics
   are folded in once per train step by :meth:`update_statistics`,
   which here updates the buffers in place and returns the module.
2. *carry state*: an explicit per-env tree threaded by the algorithm and
   reset at episode boundaries (RNN hiddens, delay buffers, the AR1
   bottleneck's last latent, a population graph's ring buffers).

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

from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack, tree_where

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


# Alias for API parity with the JAX name.
StatefulModuleOutput = ModuleOutput


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
    ) -> tuple[Any, torch.Tensor, ModuleState]:
        """Replay over a whole ``[T, B, ...]`` stored sequence
        (``nnx_ppo_tpu/networks/types.py:120-180``).

        Returns ``(output_seq, reg_seq, final_state)``; the carry is
        reset per env where ``done_seq[t]``, after step t, as in the
        rollout (``rollout.single_transition``). A replay-time-static
        module runs ONE forward over the ``[T, B]`` leading dims; its
        carry is constant, so ``final_state`` is the carry it was given,
        and its ``reg_seq`` is what that forward gives: a float, or a
        tensor that broadcasts against ``[T, B]`` (JAX broadcasts it to
        ``[T, B]``; on the card that would be a copy and an add per
        layer and minibatch, and every reader takes a mean or a
        broadcasting sum). Any other module runs the step-wise time scan
        (:func:`scan_replay`), whose ``reg_seq`` is ``[T, B]``. Recurrent
        modules and containers override this with faster forms of the
        same function.
        """
        if self.replay_time_static:
            out = self(state, obs_seq, extras_seq)
            return out.output, out.regularization_loss, state
        return scan_replay(self, state, obs_seq, done_seq, extras_seq)


def _normalize_reg(reg: Any, T: int, B: int, device: torch.device) -> torch.Tensor:
    """Broadcast a regularization loss (a float, or a tensor that
    broadcasts against ``[T, B]``) to ``[T, B]`` (``types.py:222-227``);
    the scan uses it per step, with ``T = 1``."""
    return torch.broadcast_to(torch.as_tensor(reg, dtype=torch.float32, device=device), (T, B))


def scan_replay(
    module: StatefulModule,
    state: ModuleState,
    obs_seq: Any,
    done_seq: torch.Tensor,
    extras_seq: Any,
) -> tuple[Any, torch.Tensor, ModuleState]:
    """The step-wise time scan (``types.py:168-180``, and the whole-net
    scan of ``nnx_ppo_tpu/algorithms/ppo.py:573-585``): step t runs the
    forward on ``obs_seq[t]`` with ``extras_seq[t]``; then the carry is
    ``reset_state`` where ``done_seq[t]``. Returns ``(output_seq,
    reg_seq [T, B], final_state)``."""
    T, B = done_seq.shape
    outputs, regs = [], []
    for t in range(T):
        extras_t = tree_map(lambda x: x[t], extras_seq)
        out = module(state, tree_map(lambda x: x[t], obs_seq), extras_t)
        outputs.append(out.output)
        regs.append(_normalize_reg(out.regularization_loss, 1, B, done_seq.device)[0])
        state = tree_where(done_seq[t], module.reset_state(out.next_state), out.next_state)
    return tree_stack(outputs), torch.stack(regs), state


def replay_sequence_nd(
    module: StatefulModule,
    module_state: ModuleState,
    obs_bt: Any,
    n_steps: int,
    extras_bt: Any,
    done_bt: Optional[torch.Tensor] = None,
) -> tuple[Any, Any, ModuleState]:
    """The fused replay over **batch-major** ``[B, T, ...]`` buffers
    (``nnx_ppo_tpu/networks/types.py:230-291``) for a fully
    replay-time-static network: each layer runs one forward over the
    ``[B, T]`` leading dims, so neither the time order nor the per-env
    ``done`` resets matter.

    Each per-env carry leaf is broadcast over T with ``expand`` (a view,
    not a copy); the port's carries hold no PRNG keys (one
    ``torch.Generator``, see the module docstring), so no per-step key is
    made. The forward runs through the modules' ``replay_sequence``
    (``done_bt`` is read for its ``[B, T]`` shape only; a broadcast False
    when not given), which for static layers is their forward over the
    leading dims, and lets a layer whose step form folds every axis past
    the first flatten below both leading dims instead: a departure from
    JAX's one whole-net forward, whose ``Flattener`` folds T into the
    features and raises on dict observations
    (``nnx_ppo_tpu/networks/utils.py:49-54``).

    Returns ``(output_bt [B, T, ...], reg_bt, final_state)``: ``reg_bt``
    is what the forward gives (a float or a tensor that broadcasts against
    ``[B, T]``, as :meth:`StatefulModule.replay_sequence` returns it;
    every reader takes a mean); ``final_state`` is
    :func:`advance_state_keys` of the carry it was given, which is that
    carry: JAX's ``final_state`` argument, a carry to return in its place,
    has no caller here and is not taken. Any other network raises JAX's
    ``ValueError``."""
    if not module.replay_time_static:
        raise ValueError(
            "replay_sequence_nd requires a fully replay-time-static "
            "network (every module's replay output independent of carry "
            "values); use the time-major replay_sequence path for "
            "recurrent networks."
        )
    T = n_steps
    B = tree_leaves(obs_bt)[0].shape[0]
    if done_bt is None:
        device = tree_leaves(obs_bt)[0].device
        done_bt = torch.zeros((), dtype=torch.bool, device=device).expand(B, T)
    nd_state = tree_map(lambda x: x.unsqueeze(1).expand(x.shape[0], T, *x.shape[1:]), module_state)
    output, reg, _ = module.replay_sequence(nd_state, obs_bt, done_bt, extras_bt)
    return output, reg, advance_state_keys(module_state, T)


def advance_state_keys(module_state: ModuleState, n_steps: int) -> ModuleState:
    """``nnx_ppo_tpu/networks/types.py:294-305``: advance every PRNG-key
    leaf of a per-env carry by ``n_steps`` splits. The port's carries hold
    no keys (every draw comes from the caller's generator), so this is the
    identity: the carry it is given."""
    del n_steps
    return module_state
