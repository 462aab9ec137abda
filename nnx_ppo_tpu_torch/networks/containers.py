"""Sequential container. Port of ``nnx_ppo_tpu/networks/containers.py:40``.

Carry and extras are per-layer tuples; metrics are keyed by integer
layer index; regularization losses are summed. ``Concat``, ``Parallel``
and ``Splitter`` are not on this slice's path.
"""

from __future__ import annotations

from typing import Any, Iterable

from torch import nn

from nnx_ppo_tpu_torch.networks.types import (
    ModuleOutput,
    ModuleState,
    StatefulModule,
)


class Sequential(StatefulModule):
    """Ordered chain of modules."""

    def __init__(self, layers: Iterable[StatefulModule]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, layers: Iterable[StatefulModule]) -> "Sequential":
        return cls(layers)

    def _check_routing(self, state, rollout_extras) -> None:
        # A silent zip truncation would feed layers the wrong extras.
        if len(state) != len(self.layers):
            raise ValueError(
                f"Sequential: carry has {len(state)} entries for "
                f"{len(self.layers)} layers"
            )
        if rollout_extras is not None and len(rollout_extras) != len(self.layers):
            raise ValueError(
                f"Sequential: rollout_extras has {len(rollout_extras)} "
                f"entries for {len(self.layers)} layers"
            )

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        self._check_routing(state, rollout_extras)
        new_state = []
        new_extras = []
        reg_loss: Any = 0.0
        metrics: dict[int, Any] = {}
        for i, (layer, layer_state) in enumerate(zip(self.layers, state)):
            layer_extras = None if rollout_extras is None else rollout_extras[i]
            out = layer(layer_state, x, layer_extras, generator)
            new_state.append(out.next_state)
            new_extras.append(out.rollout_extras)
            x = out.output
            reg_loss = reg_loss + out.regularization_loss
            metrics[i] = out.metrics
        return ModuleOutput(tuple(new_state), x, reg_loss, metrics, tuple(new_extras))

    def initialize_state(self, batch_size: int) -> ModuleState:
        return tuple(layer.initialize_state(batch_size) for layer in self.layers)

    def reset_state(self, prev_state) -> ModuleState:
        return tuple(
            layer.reset_state(s) for layer, s in zip(self.layers, prev_state)
        )

    def update_statistics(self, rollout_extras) -> "Sequential":
        for layer, extras in zip(self.layers, rollout_extras):
            layer.update_statistics(extras)
        return self

    def __getitem__(self, ind: int) -> StatefulModule:
        return self.layers[ind]

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def replay_time_static(self) -> bool:
        return all(layer.replay_time_static for layer in self.layers)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """Layer-wise over time: each child replays the whole sequence
        before the next one runs (``containers.py:112``)."""
        self._check_routing(state, extras_seq)
        x = obs_seq
        reg_seq: Any = 0.0
        finals = []
        for i, (layer, layer_state) in enumerate(zip(self.layers, state)):
            layer_extras = None if extras_seq is None else extras_seq[i]
            x, reg, final = layer.replay_sequence(
                layer_state, x, done_seq, layer_extras
            )
            reg_seq = reg_seq + reg
            finals.append(final)
        return x, reg_seq, tuple(finals)
