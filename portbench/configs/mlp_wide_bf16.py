"""The ``mlp_wide_bf16`` configuration as the port runs it: env,
networks, PPO settings and optimizer from ``mlp_wide_bf16.json`` and the
cell's traffic, the map from the benchmark's weight names to the port's
parameters and statistics, and the env state as the benchmark compares
it."""

from __future__ import annotations

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def build(cfg: dict, traffic: dict) -> dict:
    e, net = cfg["env"], cfg["network"]
    env = EpisodeWrapper(CartpoleBalance(), max_len=e["episode_length"])
    networks = make_mlp_actor_critic(
        e["obs"], e["n_act"], net["actor_hidden"], net["critic_hidden"], 0,
        normalize_obs=net["normalize_obs"], entropy_weight=net["entropy_weight"],
        min_std=net["min_std"], compute_dtype=cfg["compute_dtype"],
    )
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
    for name, hidden in (("actor", net["actor_hidden"]), ("critic", net["critic_hidden"])):
        port = "action" if name == "actor" else "value"
        for i in range(len(hidden) + 1):
            port_names[f"{name}.{i}.W"] = f"layers.1.{port}.layers.{i}.kernel"
            port_names[f"{name}.{i}.b"] = f"layers.1.{port}.layers.{i}.bias"
    return {"env": env, "networks": networks, "config": config,
            "optimizer": make_optimizer(config.learning_rate), "port_names": port_names,
            "stat_names": {"count": "layers.0.counter", "mean": "layers.0.mean",
                           "M2": "layers.0.M2"}}


def env_state(state) -> dict:
    """The env state, flat, with the reference's keys."""
    return {"q": state.data["q"], "obs": state.obs, "reward": state.reward, "done": state.done,
            "step_counter": state.info["step_counter"], "truncated": state.info["truncated"]}
