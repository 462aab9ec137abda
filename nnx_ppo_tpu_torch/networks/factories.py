"""Network factories. Port of ``nnx_ppo_tpu/networks/factories.py``.

The JAX factories take one PRNG key; these take an integer ``seed`` and
draw every layer's initial weights, in order, from one CPU
``torch.Generator`` seeded with it. Modules are built on the CPU; the
training entry points move them to their device. ``compute_dtype``
(``factories.py:85``, e.g. ``torch.bfloat16`` or ``"bfloat16"``) runs
every Dense matmul on bf16-rounded operands with a float32 product
(``feedforward.Dense``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
import torch.nn.functional as F

from nnx_ppo_tpu_torch.networks.adapter import PPOAdapter
from nnx_ppo_tpu_torch.networks.containers import Sequential
from nnx_ppo_tpu_torch.networks.feedforward import Dense
from nnx_ppo_tpu_torch.networks.normalizer import Normalizer
from nnx_ppo_tpu_torch.networks.sampling_layers import NormalTanhSampler
from nnx_ppo_tpu_torch.networks.types import StatefulModule


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": torch.relu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "gelu": _gelu,
}


def make_mlp_layers(
    sizes: Sequence[int],
    generator: torch.Generator,
    activation: Callable = torch.relu,
    activation_last_layer: bool = True,
    initializer_scale: float = 1.0,
    compute_dtype: Union[None, str, torch.dtype] = None,
) -> list[Dense]:
    """Dense layers for an MLP; ``sizes`` includes input and output."""
    layers = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        is_last = i == len(sizes) - 2
        act = activation if (not is_last or activation_last_layer) else None
        layers.append(
            Dense.create(
                din, dout, generator, act, initializer_scale=initializer_scale,
                compute_dtype=compute_dtype,
            )
        )
    return layers


def make_mlp(
    sizes: Sequence[int],
    generator: torch.Generator,
    activation: Callable = torch.relu,
    activation_last_layer: bool = True,
    initializer_scale: float = 1.0,
    compute_dtype: Union[None, str, torch.dtype] = None,
) -> Sequential:
    """An MLP as a Sequential of Dense layers."""
    return Sequential.create(
        make_mlp_layers(
            sizes, generator, activation, activation_last_layer, initializer_scale, compute_dtype
        )
    )


def make_mlp_actor_critic(
    obs_size: int,
    action_size: int,
    actor_hidden_sizes: Sequence[int],
    critic_hidden_sizes: Sequence[int],
    seed: int = 0,
    activation: Union[Callable, str] = torch.relu,
    normalize_obs: bool = True,
    initializer_scale: float = 1.0,
    entropy_weight: float = 1e-2,
    min_std: float = 1e-1,
    std_scale: float = 1.0,
    compute_dtype: Union[None, str, torch.dtype] = None,
) -> StatefulModule:
    """Standard one-actor / one-critic PPO network::

        Sequential([
            Normalizer(obs_size)?,        # if normalize_obs
            PPOAdapter(
                action=Sequential([actor_mlp..., NormalTanhSampler]),
                value=critic_mlp,
            ),
        ])

    The actor's last layer outputs ``2 * action_size`` features
    (mean | raw std) with no activation; the critic outputs 1. Kernels
    use variance-scaling fan-in uniform init; biases start at zero.
    ``compute_dtype`` applies to every Dense layer.
    """
    if isinstance(activation, str):
        activation = _ACTIVATIONS[activation]
    generator = torch.Generator().manual_seed(seed)
    actor_layers = make_mlp_layers(
        [obs_size, *actor_hidden_sizes, action_size * 2],
        generator,
        activation,
        activation_last_layer=False,
        initializer_scale=initializer_scale,
        compute_dtype=compute_dtype,
    )
    critic = Sequential.create(
        make_mlp_layers(
            [obs_size, *critic_hidden_sizes, 1],
            generator,
            activation,
            activation_last_layer=False,
            initializer_scale=initializer_scale,
            compute_dtype=compute_dtype,
        )
    )
    sampler = NormalTanhSampler.create(
        entropy_weight=entropy_weight, min_std=min_std, std_scale=std_scale
    )
    adapter = PPOAdapter.create(
        action=Sequential.create([*actor_layers, sampler]), value=critic
    )
    if normalize_obs:
        return Sequential.create([Normalizer.create(obs_size), adapter])
    return adapter
