"""The ``cartpole_gru`` configuration as the port runs it: env, networks,
PPO settings and optimizer from ``cartpole_gru.json`` and the cell's
traffic, the map from the benchmark's weight names to the port's
parameters, the env state and the network's carry as the benchmark
compares them."""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import GRU, Dense, NormalTanhSampler, PPOAdapter, Sequential
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

from portbench.configs.mlp_wide_bf16 import env_state  # noqa: F401  (the same env)


def build(cfg: dict, traffic: dict) -> dict:
    e, net = cfg["env"], cfg["network"]
    env = EpisodeWrapper(CartpoleBalance(), max_len=e["episode_length"])
    g = torch.Generator().manual_seed(0)  # shapes only: the benchmark's weights replace these
    h = net["hidden"]
    actor = Sequential.create([
        GRU.create(e["obs"], h, g), Dense.create(h, 2 * e["n_act"], g),
        NormalTanhSampler.create(entropy_weight=net["entropy_weight"], min_std=net["min_std"]),
    ])
    critic = Sequential.create([GRU.create(e["obs"], h, g), Dense.create(h, 1, g)])
    networks = PPOAdapter.create(action=actor, value=critic)
    p = cfg["ppo"]
    config = PPOConfig(
        n_envs=traffic["n_envs"], rollout_length=traffic["rollout_length"],
        n_epochs=traffic["n_epochs"], n_minibatches=traffic["n_minibatches"],
        learning_rate=p["learning_rate"], clip_range=p["clip_range"], gae_lambda=p["gae_lambda"],
        discounting_factor=p["discounting_factor"],
        normalize_advantages=p["normalize_advantages"],
        combine_advantages=p["combine_advantages"], critic_loss_weight=p["critic_loss_weight"],
    )
    port_names = {}
    for name, port in (("actor", "action"), ("critic", "value")):
        port_names.update({f"{name}.gru.in.W": f"{port}.layers.0.wi",
                           f"{name}.gru.rec.W": f"{port}.layers.0.wh",
                           f"{name}.gru.b": f"{port}.layers.0.bias",
                           f"{name}.out.W": f"{port}.layers.1.kernel",
                           f"{name}.out.b": f"{port}.layers.1.bias"})
    return {"env": env, "networks": networks, "config": config,
            "optimizer": make_optimizer(config.learning_rate), "port_names": port_names,
            "stat_names": {}}


def carry_state(network_states) -> dict:
    """The network's carry, flat, with the reference's keys: each GRU's h."""
    return {"actor.h": network_states["action"][0], "critic.h": network_states["value"][0]}
