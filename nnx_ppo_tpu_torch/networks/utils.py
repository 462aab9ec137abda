"""Utility modules: Flattener, Filter, Scale, Merge, Map.

Port of ``nnx_ppo_tpu/networks/utils.py``. The stateless layers have an
empty carry; ``Merge`` and ``Map`` route their children's carry, extras,
metrics and regularization as the named containers do, and replay them
layer-wise over time (``utils.py:162``, ``:196``).
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch

from nnx_ppo_tpu_torch.core.struct import tree_map
from nnx_ppo_tpu_torch.networks.containers import _NamedContainer
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule

FilterSpec = Union[str, tuple, Callable[[Any], Any]]


def _sorted_leaves(x: Any) -> list:
    """Leaves in JAX's order: dict keys sorted, ``None`` skipped."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _sorted_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _sorted_leaves(v)]
    return [x]


def _flatten_at_depth(x: Any, preserve_levels: int, n_batch: int) -> Any:
    """Concatenate the leaves below ``preserve_levels`` levels of
    dict/list/tuple structure along their flattened features, keeping
    ``n_batch`` leading axes (1 in the step, 2 in the ``[T, B]`` replay)."""
    if preserve_levels == 0:
        return torch.cat(
            [a.reshape(a.shape[:n_batch] + (-1,)) for a in _sorted_leaves(x)], dim=-1
        )
    if isinstance(x, dict):
        return {k: _flatten_at_depth(v, preserve_levels - 1, n_batch) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_flatten_at_depth(v, preserve_levels - 1, n_batch) for v in x)
    raise TypeError(
        "Flattener(preserve_levels > 0) requires dict/list/tuple at each "
        f"preserved level; encountered a leaf of type {type(x).__name__} "
        f"with {preserve_levels} levels still to preserve."
    )


class Flattener(StatefulModule):
    """Flatten a tree into one tensor (``preserve_levels=0``) or keep the
    top N levels of dict/list/tuple structure and flatten below."""

    def __init__(self, preserve_levels: int = 0):
        super().__init__()
        if preserve_levels < 0:
            raise ValueError(f"preserve_levels must be >= 0, got {preserve_levels}")
        self.preserve_levels = preserve_levels

    @classmethod
    def create(cls, preserve_levels: int = 0) -> "Flattener":
        return cls(preserve_levels)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        return ModuleOutput((), _flatten_at_depth(x, self.preserve_levels, 1), 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        T, B = done_seq.shape
        output = _flatten_at_depth(obs_seq, self.preserve_levels, 2)
        return output, torch.zeros((T, B), device=done_seq.device), state


class Filter(StatefulModule):
    """Declarative tree extraction: ``{output_key: extraction}``, where an
    extraction is a string (top-level key), a tuple of strings / ints (a
    nested path) or a callable applied to the whole input."""

    def __init__(self, spec: dict[str, FilterSpec]):
        super().__init__()
        if not isinstance(spec, dict):
            raise TypeError(f"Filter spec must be a dict; got {type(spec).__name__}")
        for out_key, sub in spec.items():
            if not isinstance(sub, (str, tuple)) and not callable(sub):
                raise TypeError(
                    f"Filter spec for {out_key!r} must be str, tuple, or "
                    f"callable; got {type(sub).__name__}"
                )
        self.spec = tuple(spec.items())

    @classmethod
    def create(cls, spec: dict[str, FilterSpec]) -> "Filter":
        return cls(spec)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        output: dict[str, Any] = {}
        for out_key, sub in self.spec:
            if isinstance(sub, str):
                output[out_key] = x[sub]
            elif isinstance(sub, tuple):
                v = x
                for p in sub:
                    v = v[p]
                output[out_key] = v
            else:
                output[out_key] = sub(x)
        return ModuleOutput((), output, 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True


class Scale(StatefulModule):
    """Multiply the input tree by a fixed scalar."""

    def __init__(self, factor: float):
        super().__init__()
        self.factor = float(factor)

    @classmethod
    def create(cls, factor: float) -> "Scale":
        return cls(factor)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        return ModuleOutput(state, tree_map(lambda v: v * self.factor, x), 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True


def _merge(outputs: dict[str, Any]) -> dict[str, Any]:
    merged: dict[str, Any] = {}
    for name, out in outputs.items():
        if not isinstance(out, dict):
            raise TypeError(f"Merge component {name!r} must return a dict; got {type(out).__name__}")
        for k, v in out.items():
            if k in merged:
                raise ValueError(f"Merge: duplicate key {k!r} produced by multiple components")
            merged[k] = v
    return merged


class Merge(_NamedContainer):
    """Named children on the same input, each returning a dict, merged
    into one flat dict; a key produced twice is an error."""

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        new_state, new_extras, outputs, reg_loss, metrics = self._run_children(
            state, rollout_extras, generator, lambda key: x
        )
        return ModuleOutput(new_state, _merge(outputs), reg_loss, metrics, new_extras)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        outputs, reg_seq, finals = self._replay_children_sequence(
            state, done_seq, extras_seq, lambda key: obs_seq
        )
        return _merge(outputs), reg_seq, finals


class Map(_NamedContainer):
    """Per-key dispatch: dict input -> dict output; each named child sees
    the upstream's same-named entry, other input keys are dropped."""

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        new_state, new_extras, outputs, reg_loss, metrics = self._run_children(
            state, rollout_extras, generator, lambda key: x[key]
        )
        return ModuleOutput(new_state, outputs, reg_loss, metrics, new_extras)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        return self._replay_children_sequence(
            state, done_seq, extras_seq, lambda key: obs_seq[key]
        )
