"""The ``quadruped_rough`` configuration as the port runs it: env,
networks, PPO settings and optimizer from ``quadruped_rough.json`` and
the cell's traffic, the map from the benchmark's weight names to the
port's parameters, and the env state as the benchmark compares it."""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
from nnx_ppo_tpu_torch.envs import QuadrupedJoystick
from nnx_ppo_tpu_torch.networks import (
    Concat, Dense, NormalTanhSampler, Parallel, PPOAdapter, Sequential, make_mlp,
)
from nnx_ppo_tpu_torch.physics import DomainRandomization
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def build(cfg: dict, traffic: dict) -> dict:
    e, net = cfg["env"], cfg["network"]
    legged = QuadrupedJoystick(
        kp=e["kp"], action_scale=e["action_scale"], control_dt=e["control_dt"],
        n_substeps=e["n_substeps"], max_command=tuple(e["max_command"]),
        command_resample_prob=e["command_resample_prob"], tracking_sigma=e["tracking_sigma"],
        min_up=e["min_up"], min_height=e["min_height"], reset_joint_noise=e["reset_joint_noise"],
        spawn_radius=e["spawn_radius"], reuse_mass_matrix=e["reuse_mass_matrix"],
        randomize=DomainRandomization(**{k: tuple(v) for k, v in e["domain_randomization"].items()}),
        push_prob=e["push_prob"], push_force=e["push_force"],
        terrain=rough_terrain(**e["terrain"]), substep_impl="pallas",
    )
    env = EpisodeWrapper(legged, max_len=e["episode_length"])
    g = torch.Generator().manual_seed(0)  # shapes only: the benchmark's weights replace these
    enc = Concat.create(**{k: Dense.create(e["obs"][k], w, g, torch.relu)
                           for k, w in net["encoder"].items()})
    width = sum(net["encoder"].values())
    actor_sizes = [width, *net["actor_hidden"], 2 * e["n_act"]]
    actor = Sequential.create([
        *[Dense.create(a, b, g, torch.relu if i < len(actor_sizes) - 2 else None)
          for i, (a, b) in enumerate(zip(actor_sizes[:-1], actor_sizes[1:]))],
        NormalTanhSampler.create(entropy_weight=net["entropy_weight"], min_std=net["min_std"]),
    ])
    critic = Parallel.create(**{k: make_mlp([width, *net["critic_hidden"], 1], g,
                                            activation_last_layer=False)
                                for k in cfg["reward_keys"]})
    networks = Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])
    p = cfg["ppo"]
    config = PPOConfig(
        n_envs=traffic["n_envs"], rollout_length=traffic["rollout_length"],
        n_epochs=traffic["n_epochs"], n_minibatches=traffic["n_minibatches"],
        learning_rate=p["learning_rate"], clip_range=p["clip_range"], gae_lambda=p["gae_lambda"],
        discounting_factor=p["discounting_factor"],
        normalize_advantages=p["normalize_advantages"],
        combine_advantages=p["combine_advantages"], critic_loss_weight=p["critic_loss_weight"],
    )
    names = {f"enc.{k}": f"layers.0.components.{k}" for k in net["encoder"]}
    names.update({f"actor.{i}": f"layers.1.action.layers.{i}" for i in range(len(actor_sizes) - 1)})
    names.update({f"critic.{k}.{i}": f"layers.1.value.components.{k}.layers.{i}"
                  for k in cfg["reward_keys"] for i in range(len(net["critic_hidden"]) + 1)})
    port_names = {}
    for ref, port in names.items():
        port_names[ref + ".W"] = port + ".kernel"
        port_names[ref + ".b"] = port + ".bias"
    return {"env": env, "networks": networks, "config": config,
            "optimizer": make_optimizer(config.learning_rate), "port_names": port_names,
            "stat_names": {}}


def env_state(state) -> dict:
    """The env state, flat, with the reference's keys."""
    d = state.data
    out = {k: d[k] for k in ("qpos", "qvel", "cmd", "prev_action")}
    for name in ("mass_scale", "friction", "damping_scale", "gain_scale"):
        value = getattr(d["dr"], name)
        if value is not None:
            out["dr." + name] = value
    out.update({"obs.proprio": state.obs["proprio"], "obs.command": state.obs["command"],
                "reward.tracking": state.reward["tracking"],
                "reward.penalty": state.reward["penalty"], "done": state.done,
                "step_counter": state.info["step_counter"], "truncated": state.info["truncated"],
                "metric.contact_force": state.metrics["contact_force"]})
    return out
