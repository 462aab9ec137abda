"""The ``granite_h_micro`` configuration as the port runs it: env,
networks, PPO settings and optimizer from ``granite_h_micro.json`` and the
cell's traffic, the map from the benchmark's weight names to the port's
parameters and statistics, the env state and the network's carry as the
benchmark compares them.

The network is ``Sequential([Normalizer, Dense(obs -> hidden),
HybridTrunk, PPOAdapter(action=Sequential([Dense(hidden -> 2),
NormalTanhSampler]), value=Dense(hidden -> 1))])``: the trunk is shared by
the actor and the critic, and runs through ``ppo_step``, ``unroll_env``
and the time-major fused replay as any carrying network does.
"""

from __future__ import annotations

import torch

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import (
    Dense,
    HybridTrunk,
    NormalTanhSampler,
    Normalizer,
    PPOAdapter,
    Sequential,
)
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

from portbench.configs.mlp_wide_bf16 import env_state  # noqa: F401  (the same env)

TRUNK = "layers.2"


def build(cfg: dict, traffic: dict) -> dict:
    e, net = cfg["env"], cfg["network"]
    env = EpisodeWrapper(CartpoleBalance(), max_len=e["episode_length"])
    g = torch.Generator().manual_seed(0)  # shapes only: the benchmark's weights replace these
    dtype, D = cfg["compute_dtype"], cfg["hidden_size"]
    trunk = HybridTrunk.create(
        D, cfg["layer_types"], g, intermediate=cfg["shared_intermediate_size"],
        mamba=dict(n_heads=cfg["mamba_n_heads"], head_dim=cfg["mamba_d_head"],
                   d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                   chunk_size=cfg["mamba_chunk_size"]),
        attention=dict(n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
                       capacity=net["kv_cache_capacity"],
                       multiplier=cfg["attention_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        embedding_multiplier=cfg["embedding_multiplier"], eps=cfg["rms_norm_eps"],
        compute_dtype=dtype,
    )
    actor = Sequential.create([
        Dense.create(D, 2 * e["n_act"], g, compute_dtype=dtype),
        NormalTanhSampler.create(entropy_weight=net["entropy_weight"], min_std=net["min_std"]),
    ])
    networks = Sequential.create([
        Normalizer.create(e["obs"]),
        Dense.create(e["obs"], D, g, use_bias=False, compute_dtype=dtype),
        trunk,
        PPOAdapter.create(action=actor, value=Dense.create(D, 1, g, compute_dtype=dtype)),
    ])
    p = cfg["ppo"]
    config = PPOConfig(
        n_envs=traffic["n_envs"], rollout_length=traffic["rollout_length"],
        n_epochs=traffic["n_epochs"], n_minibatches=traffic["n_minibatches"],
        learning_rate=p["learning_rate"], clip_range=p["clip_range"], gae_lambda=p["gae_lambda"],
        discounting_factor=p["discounting_factor"],
        normalize_advantages=p["normalize_advantages"],
        combine_advantages=p["combine_advantages"], critic_loss_weight=p["critic_loss_weight"],
    )
    port_names = {"embed.W": "layers.1.kernel", "final_norm.W": f"{TRUNK}.final_norm.weight",
                  "actor.W": "layers.3.action.layers.0.kernel",
                  "actor.b": "layers.3.action.layers.0.bias",
                  "critic.W": "layers.3.value.kernel", "critic.b": "layers.3.value.bias"}
    for i, kind in enumerate(cfg["layer_types"]):
        ref, port = f"layers.{i}", f"{TRUNK}.blocks.{i}"
        names = {"input_norm.W": "input_norm.weight", "post_norm.W": "post_norm.weight",
                 "mlp.input.W": "mlp.input_linear.kernel", "mlp.output.W": "mlp.output_linear.kernel"}
        if kind == "mamba":
            names.update({"mamba.in_proj.W": "mixer.in_proj.kernel",
                          "mamba.conv.W": "mixer.conv_weight", "mamba.conv.b": "mixer.conv_bias",
                          "mamba.dt_bias": "mixer.dt_bias", "mamba.A_log": "mixer.A_log",
                          "mamba.D": "mixer.D", "mamba.norm.W": "mixer.norm.weight",
                          "mamba.out_proj.W": "mixer.out_proj.kernel"})
        else:
            names.update({f"attention.{n}.W": f"mixer.{n}_proj.kernel" for n in "qkvo"})
        port_names.update({f"{ref}.{a}": f"{port}.{b}" for a, b in names.items()})
    return {"env": env, "networks": networks, "config": config,
            "optimizer": make_optimizer(config.learning_rate), "port_names": port_names,
            "stat_names": {"count": "layers.0.counter", "mean": "layers.0.mean",
                           "M2": "layers.0.M2"}}


def carry_state(network_states) -> dict:
    """The trunk's carry, flat, with the reference's keys: each Mamba
    layer's SSM and convolution states, the attention layer's key and
    value caches and length."""
    out = {}
    for i, layer in enumerate(network_states[2]):
        names = ("ssm", "conv") if len(layer) == 2 else ("k", "v", "length")
        out.update({f"layers.{i}.{n}": x for n, x in zip(names, layer)})
    return out
