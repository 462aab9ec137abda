"""Containers. Port of ``nnx_ppo_tpu/networks/containers.py``:
``Sequential`` (:40), ``_NamedContainer`` (:127), ``Concat`` (:186),
``Parallel`` (:221) and ``Splitter`` (:247).

``Sequential``: carry and extras are per-layer tuples; metrics are keyed
by integer layer index. The named containers: carry, extras and metrics
are dicts keyed by child name. Regularization losses are summed.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import torch
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


def _named_components(
    name: str, modules: Optional[dict[str, StatefulModule]], kwargs: dict
) -> dict[str, StatefulModule]:
    if modules is not None and kwargs:
        raise ValueError(
            f"{name}: pass either a positional dict or keyword arguments, not both"
        )
    components = modules if modules is not None else kwargs
    if not components:
        raise ValueError(f"{name} requires at least one component")
    # Sorted by name, as the JAX package keeps them (its pytrees re-sort
    # dict keys), so that Concat's output layout is the same in both.
    return dict(sorted(components.items()))


class _NamedContainer(StatefulModule):
    """Shared routing for dict-keyed containers."""

    def __init__(self, components: dict[str, StatefulModule]):
        super().__init__()
        self.components = nn.ModuleDict(_named_components(type(self).__name__, components, {}))

    @classmethod
    def create(cls, modules: Optional[dict[str, StatefulModule]] = None, /, **kwargs):
        return cls(_named_components(cls.__name__, modules, kwargs))

    def _run_children(self, state, rollout_extras, generator, input_for: Callable[[str], Any]):
        new_state: dict[str, ModuleState] = {}
        new_extras: dict[str, Any] = {}
        outputs: dict[str, Any] = {}
        reg_loss: Any = 0.0
        metrics: dict[str, Any] = {}
        for key, component in self.components.items():
            child_extras = None if rollout_extras is None else rollout_extras[key]
            out = component(state[key], input_for(key), child_extras, generator)
            new_state[key] = out.next_state
            new_extras[key] = out.rollout_extras
            outputs[key] = out.output
            reg_loss = reg_loss + out.regularization_loss
            metrics[key] = out.metrics
        return new_state, new_extras, outputs, reg_loss, metrics

    def initialize_state(self, batch_size: int) -> ModuleState:
        return {k: c.initialize_state(batch_size) for k, c in self.components.items()}

    def reset_state(self, prev_state) -> ModuleState:
        return {k: c.reset_state(prev_state[k]) for k, c in self.components.items()}

    def update_statistics(self, rollout_extras) -> "_NamedContainer":
        for k, c in self.components.items():
            c.update_statistics(rollout_extras[k])
        return self

    def __getitem__(self, key: str) -> StatefulModule:
        return self.components[key]

    @property
    def replay_time_static(self) -> bool:
        return all(c.replay_time_static for c in self.components.values())

    def _replay_children_sequence(self, state, done_seq, extras_seq, input_for):
        outputs: dict[str, Any] = {}
        finals: dict[str, ModuleState] = {}
        reg_seq: Any = 0.0
        for key, component in self.components.items():
            child_extras = None if extras_seq is None else extras_seq[key]
            out, reg, final = component.replay_sequence(
                state[key], input_for(key), done_seq, child_extras
            )
            outputs[key] = out
            finals[key] = final
            reg_seq = reg_seq + reg
        return outputs, reg_seq, finals


class Concat(_NamedContainer):
    """Per-key dispatch + concat: dict input, single-tensor output.

    Each named child sees the upstream's same-named entry; child outputs
    are concatenated along the last axis in sorted name order.
    """

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        new_state, new_extras, outputs, reg_loss, metrics = self._run_children(
            state, rollout_extras, generator, lambda key: x[key]
        )
        concated = torch.cat([outputs[k] for k in self.components], dim=-1)
        return ModuleOutput(new_state, concated, reg_loss, metrics, new_extras)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        outputs, reg_seq, finals = self._replay_children_sequence(
            state, done_seq, extras_seq, lambda key: obs_seq[key]
        )
        return torch.cat([outputs[k] for k in self.components], dim=-1), reg_seq, finals


class Parallel(_NamedContainer):
    """Same input to every named child → dict output (fan-out to heads)."""

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        new_state, new_extras, outputs, reg_loss, metrics = self._run_children(
            state, rollout_extras, generator, lambda key: x
        )
        return ModuleOutput(new_state, outputs, reg_loss, metrics, new_extras)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        return self._replay_children_sequence(
            state, done_seq, extras_seq, lambda key: obs_seq
        )


class Splitter(StatefulModule):
    """Split a flat tensor into named last-axis slices (dict output), in
    declaration order; features past the last slice are dropped."""

    def __init__(self, sizes: dict[str, int]):
        super().__init__()
        if not sizes:
            raise ValueError("Splitter requires at least one named slice")
        for k, v in sizes.items():
            if v <= 0:
                raise ValueError(f"slice size for {k!r} must be positive, got {v}")
        self.sizes = tuple(sizes.items())

    @classmethod
    def create(cls, **sizes: int) -> "Splitter":
        return cls(sizes)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        outputs: dict[str, Any] = {}
        offset = 0
        for key, size in self.sizes:
            outputs[key] = x[..., offset : offset + size]
            offset += size
        return ModuleOutput((), outputs, 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True
