"""Recurrent layers: LSTM and GRU.

Port of ``nnx_ppo_tpu/networks/recurrent.py:30-290``. The weights keep
the JAX layout: fused kernels ``wi [in, G*H]`` and ``wh [H, G*H]`` and
one bias on the input side, gates in the order (i, f, g, o) for the LSTM
and (r, z, n) for the GRU, with ``n = tanh(x @ Wi_n + b_n + r * (h @
Wh_n))``. ``torch.nn.GRU`` / ``nn.LSTM`` keep two biases and put
``b_hn`` inside the ``r *`` term, so they compute another function; the
cells here are written out as the JAX package writes them.

Carry: ``(h, c)`` for the LSTM, ``h`` for the GRU, each ``[B, H]``,
reset at episode boundaries to zeros, or to the trainable
``initial_h`` / ``initial_c`` (``trainable_initial_state=True``), which
receive a gradient through the resets of the replay. The carry a module
hands out fresh (:meth:`initialize_state`) is data, detached from them,
as the JAX training state's carries are.

``replay_sequence`` hoists the input projection out of the time loop:
``x @ wi + bias`` for all T steps is one ``[T*B, in]`` matmul, and only
the ``h``-half runs step by step. The output at step t is ``new_h``
(before the reset); the carry is ``where(done, reset_state(new_h),
new_h)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule

# jax.nn.initializers.lecun_normal: a normal truncated at two standard
# deviations, scaled so that its variance is 1 / fan_in.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / shape[0]) / _TRUNCATED_NORMAL_STD
    return nn.init.trunc_normal_(
        torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std, generator=generator
    )


def orthogonal(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    return nn.init.orthogonal_(torch.empty(shape), generator=generator)


def _fused_kernels(
    in_features: int,
    hidden_features: int,
    n_gates: int,
    generator: torch.Generator,
    kernel_init: Optional[Callable],
    recurrent_kernel_init: Optional[Callable],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-gate initial columns, concatenated (``recurrent.py:66-83``)."""
    kernel_init = kernel_init or lecun_normal
    recurrent_kernel_init = recurrent_kernel_init or orthogonal
    wi = torch.cat(
        [kernel_init((in_features, hidden_features), generator) for _ in range(n_gates)], dim=1
    )
    wh = torch.cat(
        [recurrent_kernel_init((hidden_features, hidden_features), generator)
         for _ in range(n_gates)],
        dim=1,
    )
    return wi, wh


class _Recurrent(StatefulModule):
    """Shared parameters and carry helpers of the two cells.

    ``replay_unroll`` is kept for API parity with the JAX field (the
    unroll factor of its ``lax.scan``); the eager loop here has nothing
    to unroll, so it has no effect."""

    def __init__(self, wi, wh, bias, gate_fn, activation_fn, replay_unroll):
        super().__init__()
        self.wi = nn.Parameter(wi)
        self.wh = nn.Parameter(wh)
        self.bias = nn.Parameter(bias)
        self.gate_fn = gate_fn
        self.activation_fn = activation_fn
        self.replay_unroll = replay_unroll

    @property
    def in_features(self) -> int:
        return self.wi.shape[0]

    @property
    def hidden_features(self) -> int:
        return self.wh.shape[0]

    def _initial(self, initial: Optional[torch.Tensor], batch_size: int) -> torch.Tensor:
        shape = (batch_size, self.hidden_features)
        if initial is None:
            return torch.zeros(shape, device=self.wh.device)
        return initial.detach().expand(shape).clone()

    @staticmethod
    def _reset(initial: Optional[torch.Tensor], prev: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(prev) if initial is None else initial.expand_as(prev)


class LSTM(_Recurrent):
    """LSTM layer; gate layout along the fused kernels' last axis:
    (i, f, g, o)."""

    def __init__(
        self,
        wi: torch.Tensor,
        wh: torch.Tensor,
        bias: torch.Tensor,
        initial_h: Optional[torch.Tensor] = None,
        initial_c: Optional[torch.Tensor] = None,
        gate_fn: Callable = torch.sigmoid,
        activation_fn: Callable = torch.tanh,
        replay_unroll: int = 1,
    ):
        super().__init__(wi, wh, bias, gate_fn, activation_fn, replay_unroll)
        self.initial_h = None if initial_h is None else nn.Parameter(initial_h)
        self.initial_c = None if initial_c is None else nn.Parameter(initial_c)

    @classmethod
    def create(
        cls,
        in_features: int,
        hidden_features: int,
        generator: torch.Generator,
        *,
        gate_fn: Callable = torch.sigmoid,
        activation_fn: Callable = torch.tanh,
        kernel_init: Optional[Callable] = None,
        recurrent_kernel_init: Optional[Callable] = None,
        trainable_initial_state: bool = False,
    ) -> "LSTM":
        """Initializers take ``(shape, generator)``; defaults as JAX's:
        LeCun normal for ``wi``, orthogonal for ``wh``, zero bias."""
        wi, wh = _fused_kernels(
            in_features, hidden_features, 4, generator, kernel_init, recurrent_kernel_init
        )
        init = torch.zeros(hidden_features) if trainable_initial_state else None
        return cls(
            wi, wh, torch.zeros(4 * hidden_features),
            initial_h=init, initial_c=None if init is None else init.clone(),
            gate_fn=gate_fn, activation_fn=activation_fn,
        )

    def _cell(self, gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = self.gate_fn(f) * c + self.gate_fn(i) * self.activation_fn(g)
        new_h = self.gate_fn(o) * self.activation_fn(new_c)
        return new_h, new_c

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        h, c = state
        gates = torch.matmul(x, self.wi) + torch.matmul(h, self.wh) + self.bias
        new_h, new_c = self._cell(gates, c)
        return ModuleOutput(
            next_state=(new_h, new_c),
            output=new_h,
            regularization_loss=torch.zeros(x.shape[0], device=x.device),
            metrics={},
            rollout_extras=None,
        )

    def initialize_state(self, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self._initial(self.initial_h, batch_size), self._initial(self.initial_c, batch_size)

    def reset_state(self, prev_state) -> tuple[torch.Tensor, torch.Tensor]:
        return self._reset(self.initial_h, prev_state[0]), self._reset(self.initial_c, prev_state[1])

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """The hoisted replay (``recurrent.py:151-180``)."""
        del extras_seq
        xi_seq = torch.matmul(obs_seq, self.wi) + self.bias  # [T, B, 4H]
        h, c = state
        outputs = []
        for t in range(done_seq.shape[0]):
            new_h, new_c = self._cell(xi_seq[t] + torch.matmul(h, self.wh), c)
            outputs.append(new_h)
            reset_h, reset_c = self.reset_state((new_h, new_c))
            d = done_seq[t][:, None]
            h, c = torch.where(d, reset_h, new_h), torch.where(d, reset_c, new_c)
        return torch.stack(outputs), torch.zeros(done_seq.shape, device=done_seq.device), (h, c)


class GRU(_Recurrent):
    """GRU layer (flax ``GRUCell`` semantics): gates (r, z) and candidate
    ``n = tanh(x @ Wi_n + b_n + r * (h @ Wh_n))``."""

    def __init__(
        self,
        wi: torch.Tensor,
        wh: torch.Tensor,
        bias: torch.Tensor,
        initial_h: Optional[torch.Tensor] = None,
        gate_fn: Callable = torch.sigmoid,
        activation_fn: Callable = torch.tanh,
        replay_unroll: int = 1,
    ):
        super().__init__(wi, wh, bias, gate_fn, activation_fn, replay_unroll)
        self.initial_h = None if initial_h is None else nn.Parameter(initial_h)

    @classmethod
    def create(
        cls,
        in_features: int,
        hidden_features: int,
        generator: torch.Generator,
        *,
        kernel_init: Optional[Callable] = None,
        recurrent_kernel_init: Optional[Callable] = None,
        trainable_initial_state: bool = False,
    ) -> "GRU":
        """Initializers as :meth:`LSTM.create`'s."""
        wi, wh = _fused_kernels(
            in_features, hidden_features, 3, generator, kernel_init, recurrent_kernel_init
        )
        return cls(
            wi, wh, torch.zeros(3 * hidden_features),
            initial_h=torch.zeros(hidden_features) if trainable_initial_state else None,
        )

    def _cell(self, xi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        hh = torch.matmul(h, self.wh)
        xr, xz, xn = torch.chunk(xi, 3, dim=-1)
        hr, hz, hn = torch.chunk(hh, 3, dim=-1)
        r = self.gate_fn(xr + hr)
        z = self.gate_fn(xz + hz)
        n = self.activation_fn(xn + r * hn)
        return (1.0 - z) * n + z * h

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        new_h = self._cell(torch.matmul(x, self.wi) + self.bias, state)
        return ModuleOutput(
            next_state=new_h,
            output=new_h,
            regularization_loss=torch.zeros(x.shape[0], device=x.device),
            metrics={},
            rollout_extras=None,
        )

    def initialize_state(self, batch_size: int) -> torch.Tensor:
        return self._initial(self.initial_h, batch_size)

    def reset_state(self, prev_state: torch.Tensor) -> torch.Tensor:
        return self._reset(self.initial_h, prev_state)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """The hoisted replay (``recurrent.py:266-290``)."""
        del extras_seq
        xi_seq = torch.matmul(obs_seq, self.wi) + self.bias  # [T, B, 3H]
        h = state
        outputs = []
        for t in range(done_seq.shape[0]):
            new_h = self._cell(xi_seq[t], h)
            outputs.append(new_h)
            h = torch.where(done_seq[t][:, None], self.reset_state(new_h), new_h)
        return torch.stack(outputs), torch.zeros(done_seq.shape, device=done_seq.device), h
